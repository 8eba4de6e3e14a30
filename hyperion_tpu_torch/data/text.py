"""Tokenized-text pipeline (WikiText-2-shaped) —
`hyperion_tpu/data/text.py:28-230`, numpy only.

Sources behind one interface, searched per split in the reference's
order under `{base}/wikitext2_tokenized/`:

  1. `{split}.ids.rio` + `{split}.mask.rio` — the native recordio pair
     `data/prepare.py` writes (`data/recordio.py`). A half-written pair
     (truncated file, broken sidecar) falls through to the next source,
     as the reference's does.
  2. `{split}/data-*.arrow` — an HF-datasets arrow split, read by the
     port's own numpy reader of the Arrow IPC stream format
     (`read_arrow_stream`): the reference reads it with pyarrow, which
     the card's machine does not have. It reads what those files hold
     (`list<int>` columns, uncompressed, without dictionaries) and
     names the field and message of anything else it refuses.
  3. `{split}.npz` — a token file (`input_ids`, `attention_mask`).
  4. synthetic — `synthetic_lm_split`, bit-identical to the reference's
     arrays for the same seed.

Each on-disk read rides the IO retry/backoff (`utils/retry.py`) with
the `data_read` chaos seam, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

GPT2_VOCAB_SIZE = 50257  # the LM's vocabulary (the GPT-2 tokenizer's)
GPT2_EOS_ID = 50256      # pad = eos
DEFAULT_SEQ_LEN = 128    # tokenization window


@dataclasses.dataclass
class TextSplit:
    """One split of a tokenized corpus: [N, seq] ids + mask."""

    input_ids: np.ndarray       # int32 [N, seq]
    attention_mask: np.ndarray  # int8  [N, seq]
    source: str = "synthetic"

    def __post_init__(self):
        if self.input_ids.shape != self.attention_mask.shape:
            raise ValueError(f"ids {self.input_ids.shape} and mask "
                             f"{self.attention_mask.shape} differ")
        self.input_ids = np.ascontiguousarray(self.input_ids, dtype=np.int32)
        self.attention_mask = np.ascontiguousarray(self.attention_mask,
                                                   dtype=np.int8)

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    @property
    def seq_len(self) -> int:
        return self.input_ids.shape[1]

    def arrays(self) -> dict[str, np.ndarray]:
        return {"input_ids": self.input_ids,
                "attention_mask": self.attention_mask}

    def verify(self, vocab_size: int = GPT2_VOCAB_SIZE) -> None:
        """Ids in range, a 0/1 mask, right padding."""
        if len(self) == 0:
            raise ValueError("empty split")
        if self.input_ids.min() < 0 or self.input_ids.max() >= vocab_size:
            raise ValueError(
                f"token ids outside [0,{vocab_size}): "
                f"[{self.input_ids.min()}, {self.input_ids.max()}]")
        if not np.isin(self.attention_mask, (0, 1)).all():
            raise ValueError("attention mask must be 0/1")
        if (np.diff(self.attention_mask.astype(np.int8), axis=1) > 0).any():
            raise ValueError("attention mask is not right-padded")


# --------------------------------------------------- Arrow IPC stream

_CONTINUATION = 0xFFFFFFFF
_HEADERS = {1: "Schema", 2: "DictionaryBatch", 3: "RecordBatch",
            4: "Tensor", 5: "SparseTensor"}
_TYPE_INT, _TYPE_LIST = 2, 12
_TYPE_NAMES = {1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary",
               5: "Utf8", 6: "Bool", 7: "Decimal", 8: "Date", 9: "Time",
               10: "Timestamp", 11: "Interval", 12: "List", 13: "Struct",
               14: "Union", 15: "FixedSizeBinary", 16: "FixedSizeList",
               17: "Map", 18: "Duration", 19: "LargeBinary",
               20: "LargeUtf8", 21: "LargeList", 22: "RunEndEncoded",
               23: "BinaryView", 24: "Utf8View", 25: "ListView",
               26: "LargeListView"}


class ArrowFormatError(ValueError):
    """An Arrow stream this reader does not read (or a damaged one)."""


class _Table:
    """A flatbuffer table: `pos` is its start in `buf`, its vtable at
    `pos - int32(pos)` lists each field's offset from `pos` (0 =
    absent)."""

    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, i: int) -> int:
        o = 4 + 2 * i
        if o >= self.vt_len:
            return 0
        return struct.unpack_from("<H", self.buf, self.vt + o)[0]

    def scalar(self, i: int, fmt: str, default):
        o = self._field(i)
        return (struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0]
                if o else default)

    def _deref(self, i: int) -> int | None:
        o = self._field(i)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, i: int) -> "_Table | None":
        p = self._deref(i)
        return None if p is None else _Table(self.buf, p)

    def vector(self, i: int) -> tuple[int, int]:
        """(start of the elements, count); (0, 0) when absent."""
        p = self._deref(i)
        if p is None:
            return 0, 0
        return p + 4, struct.unpack_from("<I", self.buf, p)[0]

    def tables(self, i: int) -> list["_Table"]:
        start, n = self.vector(i)
        return [_Table(self.buf, e + struct.unpack_from("<I", self.buf, e)[0])
                for e in (start + 4 * k for k in range(n))]

    def structs(self, i: int, fmt: str) -> list[tuple]:
        start, n = self.vector(i)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, start + size * k)
                for k in range(n)]

    def string(self, i: int) -> str:
        start, n = self.vector(i)
        return bytes(self.buf[start:start + n]).decode()


def _list_field(field: _Table, where: str) -> tuple[str, np.dtype]:
    """(name, value dtype) of a `list<int>` field, or ArrowFormatError
    naming the field and what it is."""
    name = field.string(0)
    if field.table(4) is not None:
        raise ArrowFormatError(f"{where}: field {name!r} is "
                               "dictionary-encoded, which is not read")
    kind = field.scalar(2, "B", 0)
    children = field.tables(5)
    if kind != _TYPE_LIST or len(children) != 1:
        raise ArrowFormatError(
            f"{where}: field {name!r} has type "
            f"{_TYPE_NAMES.get(kind, kind)}; only list<int> is read")
    child = children[0]
    ckind = child.scalar(2, "B", 0)
    itype = child.table(3)
    if child.table(4) is not None:
        raise ArrowFormatError(f"{where}: field {name!r}'s items are "
                               "dictionary-encoded, which is not read")
    if ckind != _TYPE_INT or itype is None:
        raise ArrowFormatError(
            f"{where}: field {name!r} is list<"
            f"{_TYPE_NAMES.get(ckind, ckind)}>; only list<int> is read")
    bits, signed = itype.scalar(0, "i", 0), itype.scalar(1, "?", False)
    if bits not in (8, 16, 32, 64):
        raise ArrowFormatError(f"{where}: field {name!r} has {bits}-bit "
                               "items")
    return name, np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")


def read_arrow_stream(path: str | Path) -> dict[str, tuple[np.ndarray,
                                                           np.ndarray]]:
    """Read an Arrow IPC stream file of `list<int>` columns, with numpy
    only: {column: (row lengths, concatenated values)} over every
    record batch in order.

    The stream is a run of messages, each a continuation marker
    (0xFFFFFFFF, absent in pre-1.0 streams) and an int32 metadata
    length, the flatbuffer `Message` (a `Schema` first, then
    `RecordBatch`es) and its body; a zero length ends it. A record
    batch lists its `FieldNode`s (length, null count) and `Buffer`s
    (offset, length into the body) depth-first: a list column's
    validity and int32 offsets, then its child's validity and values.
    Refused, naming the field and the message: big-endian data, body
    compression, dictionaries, nulls, and any other type."""
    try:
        return _read_arrow_stream(path)
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ArrowFormatError(f"{path}: truncated or damaged stream "
                               f"({e})") from e


def _read_arrow_stream(path: str | Path) -> dict:
    raw = Path(path).read_bytes()
    buf = memoryview(raw)
    pos, index = 0, 0
    fields: list[tuple[str, np.dtype]] | None = None
    parts: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}
    while pos + 4 <= len(raw):
        (meta_len,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if meta_len == _CONTINUATION:
            (meta_len,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        if meta_len == 0:
            break
        meta = buf[pos:pos + meta_len]
        pos += meta_len
        msg = _Table(meta, struct.unpack_from("<I", meta, 0)[0])
        kind = msg.scalar(1, "B", 0)
        header = msg.table(2)
        body_len = msg.scalar(3, "q", 0)
        body = buf[pos:pos + body_len]
        pos += body_len
        where = (f"{path}: message {index} "
                 f"({_HEADERS.get(kind, f'type {kind}')})")
        index += 1
        if header is None:
            raise ArrowFormatError(f"{where} has no header")
        if kind == 1:
            if header.scalar(0, "h", 0) != 0:
                raise ArrowFormatError(f"{where}: big-endian data is not "
                                       "read")
            fields = [_list_field(f, where) for f in header.tables(1)]
            parts = {name: [] for name, _ in fields}
            continue
        if kind == 2:
            raise ArrowFormatError(f"{where}: dictionary batches are not "
                                   "read")
        if kind != 3:
            raise ArrowFormatError(f"{where}: only Schema and RecordBatch "
                                   "messages are read")
        if fields is None:
            raise ArrowFormatError(f"{where} comes before the schema")
        if header.table(3) is not None:
            raise ArrowFormatError(f"{where}: compressed record batch "
                                   "(body compression) is not read")
        nodes = header.structs(1, "qq")
        buffers = header.structs(2, "qq")
        if len(nodes) != 2 * len(fields) or len(buffers) != 4 * len(fields):
            raise ArrowFormatError(f"{where}: {len(nodes)} field nodes and "
                                   f"{len(buffers)} buffers for "
                                   f"{len(fields)} list columns")

        def take(b: tuple[int, int], dtype, count: int, name: str):
            off, length = b
            need = count * np.dtype(dtype).itemsize
            if off < 0 or length < need or off + need > len(body):
                raise ArrowFormatError(f"{where}: field {name!r} buffer "
                                       f"[{off}, +{length}) does not hold "
                                       f"{count} values")
            return np.frombuffer(body, dtype=dtype, count=count, offset=off)

        for k, (name, dtype) in enumerate(fields):
            (rows, list_nulls), (_, item_nulls) = nodes[2 * k:2 * k + 2]
            if list_nulls or item_nulls:
                raise ArrowFormatError(f"{where}: field {name!r} holds "
                                       "nulls, which are not read")
            offsets = take(buffers[4 * k + 1], "<i4", rows + 1, name)
            n_items = int(offsets[-1]) if rows else 0
            values = take(buffers[4 * k + 3], dtype, n_items, name)
            parts[name].append((np.diff(offsets),
                                values[offsets[0]:offsets[-1]]))
    if fields is None:
        raise ArrowFormatError(f"{path}: no schema message")
    return {name: (np.concatenate([p[0] for p in ps]) if ps
                   else np.zeros(0, np.int32),
                   np.concatenate([p[1] for p in ps]) if ps
                   else np.zeros(0, dtype))
            for (name, dtype), ps in ((f, parts[f[0]]) for f in fields)}


def load_arrow_split(split_dir: str | Path) -> TextSplit:
    """Read an HF-datasets arrow split directory (`data-*.arrow` stream
    files with `input_ids` / `attention_mask` list columns) with
    `read_arrow_stream`, without pyarrow or the `datasets` library.
    Rows of one length reshape to [N, length]; ragged rows fill their
    first `length` columns of a zero-padded [N, max length]."""
    split_dir = Path(split_dir)
    files = sorted(split_dir.glob("data-*.arrow"))
    if not files:
        raise FileNotFoundError(f"no data-*.arrow under {split_dir}")
    streams = [read_arrow_stream(f) for f in files]

    def column(name: str, dtype) -> np.ndarray:
        if any(name not in s for s in streams):
            raise ArrowFormatError(f"{split_dir}: no {name!r} column")
        lengths = np.concatenate([s[name][0] for s in streams])
        flat = np.concatenate([s[name][1] for s in streams])
        if lengths.size and (lengths == lengths[0]).all():
            return flat.reshape(len(lengths), lengths[0]).astype(dtype)
        # ragged rows: row i fills its first lengths[i] columns, in the
        # row-major order `flat` concatenates them in
        width = int(lengths.max()) if lengths.size else 0
        out = np.zeros((len(lengths), width), dtype)
        out[np.arange(width)[None, :] < lengths[:, None]] = flat
        return out

    return TextSplit(column("input_ids", np.int32),
                     column("attention_mask", np.int8),
                     source=f"arrow:{split_dir}")


def synthetic_lm_split(n_examples: int, seq_len: int = DEFAULT_SEQ_LEN,
                       vocab_size: int = GPT2_VOCAB_SIZE, seed: int = 0,
                       eos_id: int = GPT2_EOS_ID) -> TextSplit:
    """Deterministic WikiText-shaped synthetic corpus: Zipf-like token
    ranks by inverse-CDF sampling, a random true length per example and
    eos right-padding. The draws are the reference's, in its order, so
    the arrays are bit-identical for the same arguments."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    ids = cdf.searchsorted(rng.random((n_examples, seq_len)),
                           side="right").astype(np.int32)
    lengths = rng.integers(seq_len // 4, seq_len + 1, size=n_examples)
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    ids = np.where(mask, ids, eos_id).astype(np.int32)
    return TextSplit(ids, mask.astype(np.int8), source="synthetic")


def save_token_file(split: TextSplit, path: str | Path) -> None:
    """The split as a compressed npz of `input_ids` and `attention_mask`:
    the reference's token file, which `load_token_file` in either package
    reads."""
    np.savez_compressed(path, input_ids=split.input_ids,
                        attention_mask=split.attention_mask)


def load_token_file(path: str | Path) -> TextSplit:
    with np.load(path) as z:
        return TextSplit(z["input_ids"], z["attention_mask"],
                         source=f"npz:{path}")


def load_recordio_split(base: str | Path, split: str) -> TextSplit:
    """A split written by `data/prepare.py`: ids and mask as native
    recordio files."""
    from hyperion_tpu_torch.data.recordio import RecordFile

    base = Path(base)
    with RecordFile(base / f"{split}.ids.rio") as ids_f, \
            RecordFile(base / f"{split}.mask.rio") as mask_f:
        ids = ids_f.read_all()
        mask = mask_f.read_all()
    return TextSplit(ids, mask, source=f"recordio:{base / split}")


def load_wikitext2(base_dir: str | Path = "data",
                   splits: tuple[str, ...] = ("train", "validation"),
                   synthetic_sizes: dict[str, int] | None = None,
                   seq_len: int = DEFAULT_SEQ_LEN,
                   seed: int = 0) -> dict[str, TextSplit]:
    """Load the tokenized corpus, preferring on-disk data and falling
    back per split to synthetic, in the reference's search order (see
    the module docstring). Synthetic sizes are the reference's (the
    post-filter split sizes scaled down 8x); `synthetic_sizes`
    overrides them. Split i of `splits` draws from seed + i."""
    from hyperion_tpu_torch.utils.retry import (
        IO_RETRY,
        fault_point,
        retry_call,
    )

    def _read(fn):
        """A transient storage fault (or a chaos `io_fail` plan) backs
        off and retries; corrupt bytes (ValueError) surface at once."""
        def _go():
            fault_point("data_read")
            return fn()

        return retry_call(_go, policy=IO_RETRY)

    base = Path(base_dir) / "wikitext2_tokenized"
    sizes = {"train": 4590, "validation": 470, "test": 545}
    if synthetic_sizes:
        sizes.update(synthetic_sizes)
    out: dict[str, TextSplit] = {}
    for i, split in enumerate(splits):
        arrow_dir = base / split
        npz = base / f"{split}.npz"
        s = None
        if (base / f"{split}.ids.rio").exists():
            try:  # half-written prepare output falls through
                s = _read(lambda: load_recordio_split(base, split))
            except (OSError, ValueError, KeyError) as e:
                # ValueError/KeyError: a truncated or field-less sidecar
                print(f"[load_wikitext2] recordio {split} unreadable "
                      f"({e}); falling back")
        if s is None:  # no recordio split, or an unreadable one
            if arrow_dir.is_dir() and list(arrow_dir.glob("data-*.arrow")):
                s = _read(lambda: load_arrow_split(arrow_dir))
            elif npz.exists():
                s = _read(lambda: load_token_file(npz))
            else:
                s = synthetic_lm_split(sizes.get(split, 512),
                                       seq_len=seq_len, seed=seed + i)
        s.verify()
        out[split] = s
    return out
