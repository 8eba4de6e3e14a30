"""The port's compile_bench and decode_bench CLIs on the CPU against the
JAX package's (`main(argv)` with `--device cpu` at tiny sizes): the same
files with the same CSV columns and JSON keys; and
`spec_breakeven_acceptance` against the reference's. Kept apart from
`test_torch_bench_tools.py` so the two heaviest CLI comparisons run on
their own worker.
"""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest
import torch

from hyperion_tpu.bench import compile_bench as jcb
from hyperion_tpu.bench import decode_bench as jdb
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu_torch.bench import compile_bench as tcb
from hyperion_tpu_torch.bench import decode_bench as tdb
from hyperion_tpu_torch.models import transformer_lm as tt

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each CLI runs many small torch ops; under the suite's parallel
    workers a thread pool per process oversubscribes the cores and
    slows them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _header(path) -> list[str]:
    with open(path, newline="") as f:
        return next(csv.reader(f))


def _rows(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_files(jdir, tdir, names):
    for name in names:
        if name.endswith(".csv"):
            assert _header(tdir / name) == _header(jdir / name), name
        else:
            j, t = (json.loads((d / name).read_text()) for d in (jdir, tdir))
            if isinstance(j, list):
                j, t = j[0], t[0]
            assert list(t) == list(j), name


TINY_LM = dict(d_model=32, n_heads=2, n_layers=1, ff_dim=64)


def test_compile_bench_columns_match_jax(tmp_path, monkeypatch):
    """The GPT-2-shaped LM cut to d 32 and one layer in both packages
    (the GPT-2 vocab kept, ids [2, 16] for the tiers' [32, 128]), its
    three tiers (the JAX side without its interpret-mode Pallas tier:
    the columns are the tier's, not the kernel's) and the train-step
    rows at seq 16."""
    import jax
    import jax.numpy as jnp

    ids = np.random.default_rng(0).integers(0, 50257, (2, 16))
    monkeypatch.setattr(jcb, "gpt2_lm_config", lambda **kw: jt.gpt2_lm_config(
        **{**kw, **TINY_LM}))
    monkeypatch.setattr(tcb, "gpt2_lm_config", lambda **kw: tt.gpt2_lm_config(
        **{**kw, **TINY_LM}))

    def jspec(dtype, pallas=False):
        model = jt.TransformerLM(jcb.gpt2_lm_config(dropout=0.0, dtype=dtype))
        params = model.init_params(jax.random.key(0), batch=1)
        return (lambda p, x: model.apply({"params": p}, x)), params, \
            jnp.asarray(ids, jnp.int32)

    def tspec(dtype, pallas, device):
        impl = "pallas" if pallas else "xla"
        model = tt.TransformerLM(tcb.gpt2_lm_config(
            dropout=0.0, dtype=dtype, attention_impl=impl, norm_impl=impl),
            device=device).init_params(torch.Generator().manual_seed(0))
        return model, torch.as_tensor(ids)

    monkeypatch.setitem(jcb.MODEL_SPECS, "transformer_lm", jspec)
    monkeypatch.setitem(tcb.MODEL_SPECS, "transformer_lm", tspec)
    monkeypatch.setattr(jcb, "VARIANTS", ("op_by_op", "jit"))
    args = ["--models", "transformer_lm", "--repeat", "6", "--dtype", "fp32"]
    jcb.main(args + ["--out", str(tmp_path / "j")])
    tcb.main(args + ["--out", str(tmp_path / "t"), "--train-step",
                     "--train-seq", "16", "--train-batch", "2"] + CPU)
    _same_files(tmp_path / "j", tmp_path / "t",
                ["compilation_benchmark.csv", "compilation_benchmark.json"])
    rows = _rows(tmp_path / "t" / "compilation_benchmark.csv")
    assert [r["variant"] for r in rows] == [
        "op_by_op", "jit", "jit_pallas", "jit", "jit_pallas"]
    assert not any(r["note"].startswith("failed") for r in rows)
    assert rows[-1]["model"] == "transformer_lm_seq16_train"
    assert "jit" in (tmp_path / "t" / "compilation_analysis.txt").read_text()


def test_decode_bench_columns_match_jax(tmp_path, monkeypatch):
    # the tiny model at max_len 32 (512 in the spec): the chains stop at
    # its 23-step budget
    for mod in (jdb, tdb):
        monkeypatch.setitem(mod.MODEL_SPECS, "tiny", dict(max_len=32))
    args = ["--models", "tiny", "--batch", "1", "--prompt-len", "8",
            "--decode-len", "4", "--speculative", "--spec-draft", "tiny"]
    jdb.main(args + ["--out", str(tmp_path / "j")])
    tdb.main(args + ["--out", str(tmp_path / "t")] + CPU)
    _same_files(tmp_path / "j", tmp_path / "t",
                ["decode_benchmarks.csv", "spec_breakeven_tiny_tiny.json"])
    rows = _rows(tmp_path / "t" / "decode_benchmarks.csv")
    assert [(r["mode"], r["quant"]) for r in rows] == [
        ("chain", "none"), ("chain", "int8"), ("gen1_plain", "none"),
        ("gen1_spec_ceiling", "none"), ("gen1_spec_draft_tiny", "none")]
    want = [r["params_m"] for r in _rows(tmp_path / "j" /
                                         "decode_benchmarks.csv")]
    assert [r["params_m"] for r in rows] == want


@pytest.mark.parametrize("draft_ms, target_ms", [(0.1, 1.0), (0.5, 1.0),
                                                 (1.0, 1.0)])
def test_spec_breakeven_acceptance_is_the_references(draft_ms, target_ms):
    assert tdb.spec_breakeven_acceptance(draft_ms, target_ms) == \
        jdb.spec_breakeven_acceptance(draft_ms, target_ms)
