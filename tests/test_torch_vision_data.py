"""The port's data layer for the cifar job and the prepared corpora —
`data/recordio.py` (over its copy of `native/recordio.cpp`),
`data/vision.py`, `data/prepare.py` and `train/losses.py`
`classification_loss` — against the JAX package's, on the CPU.

Files are compared byte for byte: a recordio file and its JSON sidecar
written by either package are the same bytes, and each package reads
the other's. The synthetic CIFAR split is numpy from a seed in both, so
it is compared bit for bit; the pickle reader reads batch files the
test writes in the standard `cifar-10-batches-py` layout. The loss is
fp32: rtol 1e-6 (one CE over ten classes).
"""

from __future__ import annotations

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyperion_tpu.data import prepare as jprep
from hyperion_tpu.data import recordio as jrec
from hyperion_tpu.data import vision as jvis
from hyperion_tpu.data.bpe import ByteBPE as JaxBPE
from hyperion_tpu.train.losses import classification_loss as jax_cls_loss
from hyperion_tpu_torch.data import prepare as tprep
from hyperion_tpu_torch.data import recordio as trec
from hyperion_tpu_torch.data import vision as tvis
from hyperion_tpu_torch.data.bpe import train_bpe
from hyperion_tpu_torch.data.text import load_wikitext2
from hyperion_tpu_torch.train.losses import classification_loss

REPO = Path(__file__).resolve().parents[1]
CORPUS = ["the quick brown fox jumps over the lazy dog", "",
          "a stitch in time saves nine", "   ",
          "all that glitters is not gold; the early bird catches the worm",
          "to be or not to be, that is the question"] * 3


# --- recordio ----------------------------------------------------------


@pytest.mark.parametrize("dtype, row", [(np.int32, (8,)), (np.int8, (5,)),
                                        (np.float32, (4, 3, 2))])
def test_records_are_the_reference_s_bytes_both_ways(tmp_path, dtype, row):
    rows = (np.random.default_rng(0).normal(size=(17, *row)) * 50
            ).astype(dtype)
    trec.write_records(tmp_path / "t.rio", rows)
    jrec.write_records(tmp_path / "j.rio", rows)
    for suffix in ("", ".json"):
        assert (tmp_path / f"t.rio{suffix}").read_bytes() == \
            (tmp_path / f"j.rio{suffix}").read_bytes()
    with trec.RecordFile(tmp_path / "j.rio") as t, \
            jrec.RecordFile(tmp_path / "t.rio") as j:
        np.testing.assert_array_equal(t.read_all(), rows)
        np.testing.assert_array_equal(j.read_all(), rows)
        assert len(t) == len(j) == 17 and t.row_shape == row


def test_gather_shuffled(tmp_path):
    rows = np.random.default_rng(0).normal(size=(100, 4, 3)).astype(
        np.float32)
    trec.write_records(tmp_path / "d.rio", rows)
    with trec.RecordFile(tmp_path / "d.rio") as rf:
        idx = np.asarray([7, 0, 99, 42], np.uint64)
        np.testing.assert_array_equal(rf.gather(idx), rows[[7, 0, 99, 42]])


def test_out_of_range_raises(tmp_path):
    trec.write_records(tmp_path / "d.rio", np.zeros((3, 2), np.int8))
    with trec.RecordFile(tmp_path / "d.rio") as rf:
        with pytest.raises(IndexError):
            rf.gather(np.asarray([5], np.uint64))


def test_corrupt_file_rejected(tmp_path):
    p = tmp_path / "bad.rio"
    p.write_bytes(b"not a record file at all, padded" * 4)
    (tmp_path / "bad.rio.json").write_text(
        '{"dtype": "int8", "row_shape": [2]}')
    with pytest.raises(OSError):
        trec.RecordFile(p)


def test_sidecar_mismatch_rejected(tmp_path):
    trec.write_records(tmp_path / "d.rio", np.zeros((3, 2), np.int8))
    (tmp_path / "d.rio.json").write_text(
        '{"dtype": "int32", "row_shape": [2]}')
    with pytest.raises(OSError, match="record"):
        trec.RecordFile(tmp_path / "d.rio")


# --- CIFAR --------------------------------------------------------------


@pytest.mark.parametrize("n, seed", [(5000, 0), (1000, 1), (7, 9)])
def test_synthetic_split_is_bit_identical(n, seed):
    got, want = tvis.synthetic_cifar_split(n, seed), \
        jvis.synthetic_cifar_split(n, seed)
    assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def _write_pickles(d: Path, per_batch: int = 6) -> None:
    """The `cifar-10-batches-py` layout: five train batches and a test
    batch of uint8 [N, 3072] rows (CHW planes) with `labels`; one
    all-zero image in the first batch, which the validity filter
    drops."""
    d.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, (per_batch, 3072), dtype=np.uint8)
        if name == "data_batch_1":
            data[2] = 0
        labels = rng.integers(0, 10, per_batch).tolist()
        with open(d / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels}, f)


def test_pickle_reader_matches(tmp_path):
    _write_pickles(tmp_path / "cifar-10-batches-py")
    got = tvis.load_cifar_batches(tmp_path / "cifar-10-batches-py")
    want = jvis.load_cifar_batches(tmp_path / "cifar-10-batches-py")
    assert len(got["train"]) == 29 and len(got["test"]) == 6
    for name in ("train", "test"):
        np.testing.assert_array_equal(got[name].images, want[name].images)
        np.testing.assert_array_equal(got[name].labels, want[name].labels)
        assert got[name].images.shape[1:] == (32, 32, 3)


def test_load_cifar10_search_order(tmp_path):
    """recordio (`cifar10_prepared`) first, then the pickles, then
    synthetic; a half-written recordio dir falls through."""
    sizes = {"train": 40, "test": 12}
    got = tvis.load_cifar10(tmp_path, synthetic_sizes=sizes, seed=4)
    assert got["train"].source == "synthetic"
    np.testing.assert_array_equal(
        got["test"].images,
        jvis.load_cifar10(tmp_path, synthetic_sizes=sizes,
                          seed=4)["test"].images)
    _write_pickles(tmp_path / "cifar-10-batches-py")
    got = tvis.load_cifar10(tmp_path)
    assert got["train"].source.startswith("cifar:")
    tvis.save_recordio(tvis.load_cifar10_source(tmp_path, seed=4),
                       tmp_path / "cifar10_prepared")
    got = tvis.load_cifar10(tmp_path)
    want = jvis.load_cifar10(tmp_path)
    assert got["train"].source.startswith("recordio:")
    assert want["train"].source.startswith("recordio:")
    np.testing.assert_array_equal(got["train"].images, want["train"].images)
    rio = tmp_path / "cifar10_prepared" / "train.labels.rio"
    rio.write_bytes(rio.read_bytes()[:-1])
    assert tvis.load_cifar10(tmp_path)["train"].source.startswith("cifar:")


# --- prepare ------------------------------------------------------------


def test_prepare_writes_the_reference_s_bytes(tmp_path):
    """The same tokenizer, the same raw splits: the port's `.rio` files,
    sidecars and `prepare_meta.json` equal the JAX prepare's byte for
    byte, and each package's `load_wikitext2` reads the other's."""
    tok = train_bpe([x for x in CORPUS if x.strip()], vocab_size=300,
                    verbose=False)
    tok.save(tmp_path / "tok")
    raw = {"train": CORPUS, "validation": CORPUS[:5]}
    got = tprep.prepare(raw, tmp_path / "t", seq_len=16,
                        tokenizer_dir=tmp_path / "tok", verbose=False)
    jprep.prepare(raw, tmp_path / "j", seq_len=16,
                  tokenizer_dir=tmp_path / "tok", verbose=False)
    names = sorted(p.name for p in (tmp_path / "t" / "wikitext2_tokenized"
                                    ).iterdir())
    assert names == sorted(p.name for p in (
        tmp_path / "j" / "wikitext2_tokenized").iterdir())
    assert "train.ids.rio" in names and "prepare_meta.json" in names
    for name in names:
        assert (tmp_path / "t" / "wikitext2_tokenized" / name).read_bytes() \
            == (tmp_path / "j" / "wikitext2_tokenized" / name).read_bytes(), \
            name
    assert len(got["train"]) == 12  # the blank lines dropped
    back = load_wikitext2(tmp_path / "j", seq_len=16)
    assert back["validation"].source.startswith("recordio:")
    np.testing.assert_array_equal(back["train"].input_ids,
                                  got["train"].input_ids)
    assert JaxBPE.load(tmp_path / "tok").encode(CORPUS[0]) == \
        tok.encode(CORPUS[0])


def test_prepare_cli_text_and_cifar(tmp_path):
    """`python -m hyperion_tpu_torch.data.prepare`: `--input` trains and
    saves a tokenizer, writes the split and reload-verifies it;
    `--cifar` reads the source (synthetic here), never earlier prepared
    output, and writes the JAX prepare's bytes."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(CORPUS))
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.data.prepare", "--input",
         str(corpus), "--base-dir", str(tmp_path / "t"), "--seq-len", "16",
         "--vocab-size", "300"], capture_output=True, text=True, env=env,
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert "reload-verify OK" in run.stdout
    meta = json.loads((tmp_path / "t" / "wikitext2_tokenized" /
                       "prepare_meta.json").read_text())
    assert meta["splits"] == {"train": 12} and meta["seq_len"] == 16
    run = subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.data.prepare", "--cifar",
         "--base-dir", str(tmp_path / "t")], capture_output=True, text=True,
        env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "cifar reload-verify OK" in run.stdout
    jprep.prepare_cifar(tmp_path / "j", verbose=False)
    for f in sorted((tmp_path / "j" / "cifar10_prepared").iterdir()):
        assert (tmp_path / "t" / "cifar10_prepared" / f.name).read_bytes() \
            == f.read_bytes(), f.name
    with pytest.raises(SystemExit, match="nothing to prepare"):
        tprep.main(["--base-dir", str(tmp_path / "t")])


# --- the loss -----------------------------------------------------------


def test_classification_loss_matches():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 16).astype(np.int32)
    labels[:5] = logits[:5].argmax(-1)  # some right answers
    loss, counts = classification_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    jloss, jcounts = jax_cls_loss(jax.numpy.asarray(logits),
                                  jax.numpy.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in ("correct", "total"):
        assert counts[k].dtype == torch.float32
        assert float(counts[k]) == float(jcounts[k])
    assert float(counts["total"]) == 16 and float(counts["correct"]) >= 5
