"""The port's numpy reader of the Arrow IPC stream
(`hyperion_tpu_torch/data/text.py` `read_arrow_stream`) against pyarrow
and the JAX package's `load_arrow_split`, array for array: on both
committed WikiText-2 splits, and on pyarrow-written streams with ragged
rows, several record batches and sliced arrays. It reads with pyarrow
hidden, and refuses what it does not read, naming the field and the
message.
"""

import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

from hyperion_tpu.data.text import load_arrow_split as jax_load_arrow_split
from hyperion_tpu_torch.data.text import (
    ArrowFormatError,
    load_arrow_split,
    load_wikitext2,
    read_arrow_stream,
)

REPO = Path(__file__).resolve().parents[1]
SPLITS = REPO / "data" / "wikitext2_tokenized"


def pyarrow_columns(path: Path) -> dict:
    with pa.memory_map(str(path)) as src:
        table = ipc.open_stream(src).read_all()
    out = {}
    for name in table.column_names:
        col = table[name].combine_chunks()
        out[name] = (np.diff(col.offsets.to_numpy()),
                     col.flatten().to_numpy(zero_copy_only=False))
    return out


def write_stream(path: Path, batches: list, options=None) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    with pa.OSFile(str(path), "wb") as sink:
        with ipc.new_stream(sink, batches[0].schema,
                            options=options) as writer:
            for b in batches:
                writer.write_batch(b)
    return path


def ragged_batch(rng, rows: int, offset: int = 0) -> pa.RecordBatch:
    lens = rng.integers(1, 40, rows)
    ids = [list(rng.integers(0, 50257, n).astype(np.int32)) for n in lens]
    mask = [[1] * (n - 2) + [0, 0] if n > 2 else [1] * n for n in lens]
    return pa.record_batch(
        [pa.array(ids, pa.list_(pa.int32())),
         pa.array(mask, pa.list_(pa.int8()))],
        names=["input_ids", "attention_mask"])


@pytest.mark.parametrize("split, rows", [("test", 2891),
                                         ("validation", 2461)])
def test_committed_splits_equal_pyarrow_and_the_jax_reader(split, rows):
    (arrow,) = sorted((SPLITS / split).glob("data-*.arrow"))
    got, want = read_arrow_stream(arrow), pyarrow_columns(arrow)
    assert got.keys() == want.keys() == {"input_ids", "attention_mask"}
    for name in got:
        for a, b in zip(got[name], want[name]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    port = load_arrow_split(SPLITS / split)
    ref = jax_load_arrow_split(SPLITS / split)
    assert port.input_ids.shape == (rows, 128)
    for a, b in ((port.input_ids, ref.input_ids),
                 (port.attention_mask, ref.attention_mask)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port.source == f"arrow:{SPLITS / split}"


def test_ragged_rows_over_several_batches_and_files(tmp_path):
    rng = np.random.default_rng(0)
    split = tmp_path / "train"
    write_stream(split / "data-00000-of-00002.arrow",
                 [ragged_batch(rng, 7), ragged_batch(rng, 1),
                  ragged_batch(rng, 12)])
    # a sliced batch: its offsets do not start at 0
    write_stream(split / "data-00001-of-00002.arrow",
                 [ragged_batch(rng, 20).slice(5, 9)])
    for f in sorted(split.glob("*.arrow")):
        got, want = read_arrow_stream(f), pyarrow_columns(f)
        for name in want:
            for a, b in zip(got[name], want[name]):
                np.testing.assert_array_equal(a, b)
    port, ref = load_arrow_split(split), jax_load_arrow_split(split)
    assert port.input_ids.shape == ref.input_ids.shape
    assert port.input_ids.shape[0] == 7 + 1 + 12 + 9
    np.testing.assert_array_equal(port.input_ids, ref.input_ids)
    np.testing.assert_array_equal(port.attention_mask, ref.attention_mask)


def test_reads_with_pyarrow_hidden(tmp_path, monkeypatch):
    """The card's machine has no pyarrow: `load_wikitext2` reads the
    committed arrow splits without importing it."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "pyarrow"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    got = load_wikitext2(REPO / "data", splits=("test", "validation"))
    assert [len(got[s]) for s in ("test", "validation")] == [2891, 2461]
    assert all(s.source.startswith("arrow:") for s in got.values())
    assert sys.modules["pyarrow"] is None


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_refuses_a_compressed_stream_by_name(tmp_path, codec):
    if not pa.Codec.is_available(codec):
        pytest.skip(f"this pyarrow has no {codec} codec")
    rng = np.random.default_rng(1)
    path = write_stream(tmp_path / "data-00000-of-00001.arrow",
                        [ragged_batch(rng, 5)],
                        ipc.IpcWriteOptions(compression=codec))
    with pytest.raises(ArrowFormatError,
                       match=r"message 1 \(RecordBatch\): compressed"):
        read_arrow_stream(path)


def test_refuses_dictionaries_nulls_and_other_types(tmp_path):
    strings = pa.record_batch([pa.array(["a", "b"])], names=["text"])
    with pytest.raises(ArrowFormatError,
                       match=r"message 0 \(Schema\): field 'text' has "
                             r"type Utf8"):
        read_arrow_stream(write_stream(tmp_path / "s.arrow", [strings]))
    floats = pa.record_batch([pa.array([[1.0]], pa.list_(pa.float32()))],
                             names=["x"])
    with pytest.raises(ArrowFormatError, match="'x' is list<FloatingPoint>"):
        read_arrow_stream(write_stream(tmp_path / "f.arrow", [floats]))
    dicts = pa.record_batch([pa.array(["a", "b", "a"]).dictionary_encode()],
                            names=["d"])
    with pytest.raises(ArrowFormatError, match="'d' is dictionary-encoded"):
        read_arrow_stream(write_stream(tmp_path / "d.arrow", [dicts]))
    nulls = pa.record_batch([pa.array([[1], None], pa.list_(pa.int32()))],
                            names=["ids"])
    with pytest.raises(ArrowFormatError, match="'ids' holds nulls"):
        read_arrow_stream(write_stream(tmp_path / "n.arrow", [nulls]))


def test_damaged_stream_raises_instead_of_synthetic(tmp_path):
    """A split on disk is never replaced by synthetic data."""
    split = tmp_path / "wikitext2_tokenized" / "validation"
    split.mkdir(parents=True)
    (split / "data-00000-of-00001.arrow").write_bytes(b"")
    with pytest.raises(ArrowFormatError, match="no schema"):
        load_wikitext2(tmp_path, splits=("validation",))
    good = sorted((SPLITS / "validation").glob("*.arrow"))[0].read_bytes()
    (split / "data-00000-of-00001.arrow").write_bytes(good[:len(good) // 2])
    with pytest.raises(ArrowFormatError, match="does not hold"):
        load_wikitext2(tmp_path, splits=("validation",))
