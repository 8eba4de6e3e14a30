"""The port's Phase-1 tools on the CPU against the JAX package's: each
bench CLI (`python -m hyperion_tpu_torch.bench.<name>` through its
`main(argv)`) runs at tiny sizes with `--device cpu` and writes the same
files with the same CSV columns and JSON keys as the JAX module at the
same arguments; `utils/timing.py`, `bench/util.py` and
`metrics/plots.py` on their own. CPU times say nothing about the card:
these tests read the files' shape, never their numbers' size.
"""

from __future__ import annotations

import csv
import json
import math
import sys

import pytest
import torch

from hyperion_tpu.bench import attention_bench as jab
from hyperion_tpu.bench import baseline as jbl
from hyperion_tpu.bench import hw_explore as jhw
from hyperion_tpu_torch.bench import attention_bench as tab
from hyperion_tpu_torch.bench import baseline as tbl
from hyperion_tpu_torch.bench import hw_explore as thw
from hyperion_tpu_torch.bench.util import write_csv
from hyperion_tpu_torch.metrics import plots
from hyperion_tpu_torch.utils import timing

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


def test_hw_explore_columns_match_jax(tmp_path):
    args = ["--sizes", "64", "--dtypes", "float32", "bfloat16", "int8",
            "--bandwidth-elems", "1000"]
    jhw.main(args + ["--out", str(tmp_path / "j")])
    thw.main(args + ["--out", str(tmp_path / "t")] + CPU)
    _same_files(tmp_path / "j", tmp_path / "t",
                ["precision_results.csv", "bandwidth_results.csv",
                 "device_info.json"])
    rows = _rows(tmp_path / "t" / "precision_results.csv")
    assert [r["dtype"] for r in rows] == ["float32", "bfloat16", "int8"]
    assert all(float(r["time_ms"]) > 0 for r in rows)
    assert all(r["peak_tflops"] == "" for r in rows)  # no card, no peak
    bw = _rows(tmp_path / "t" / "bandwidth_results.csv")
    assert bw[0]["note"] == "cache_resident_not_hbm"


def test_attention_bench_columns_match_jax(tmp_path):
    args = ["--seqs", "128", "--geometries", "gpt2"]
    assert jab.main(args + ["--impls", "xla", "--out",
                            str(tmp_path / "j")]) == 0
    assert tab.main(args + ["--impls", "xla", "pallas", "--out",
                            str(tmp_path / "t")] + CPU) == 0
    _same_files(tmp_path / "j", tmp_path / "t", ["attention_scaling.csv"])
    rows = _rows(tmp_path / "t" / "attention_scaling.csv")
    assert {(r["impl"], r["mode"]) for r in rows} == {
        (i, m) for i in ("xla", "pallas") for m in ("fwd", "train")}
    assert all(r["status"] == "ok" for r in rows)
    assert rows[0]["kernel_rev"].startswith("sha256:")


def _small_cnn_specs(monkeypatch, size: int = 32):
    """The fallback CNN spec of both packages on [B, size, size, 3]
    images instead of 224 x 224 (the CNN is size-agnostic; the columns
    are the spec's, not the image's)."""
    import jax
    import jax.numpy as jnp

    def jspec(batch, dtype):
        model = jbl._RefFallbackCNN(dtype=dtype)
        x = jnp.zeros((batch, size, size, 3), jnp.float32)
        y = jnp.zeros((batch,), jnp.int32)
        variables = {"params": model.init({"params": jax.random.key(0)},
                                          x)["params"]}
        return variables, (lambda p, bs, x: model.apply({"params": p}, x)), \
            (x, y)

    def tspec(batch, dtype, device):
        model = tbl._RefFallbackCNN(dtype, device=device).init_params(
            torch.Generator().manual_seed(0))
        return model, model, (torch.zeros(batch, size, size, 3),
                              torch.zeros(batch, dtype=torch.long))

    monkeypatch.setitem(jbl.MODEL_SPECS, "vit_fallback_cnn", jspec)
    monkeypatch.setitem(tbl.MODEL_SPECS, "vit_fallback_cnn", tspec)


def test_baseline_columns_match_jax(tmp_path, monkeypatch):
    _small_cnn_specs(monkeypatch)
    args = ["--models", "vit_fallback_cnn", "--batch-size", "1", "--iters",
            "6"]
    jbl.main(args + ["--out", str(tmp_path / "j")])
    tbl.main(args + ["--out", str(tmp_path / "t")] + CPU)
    _same_files(tmp_path / "j", tmp_path / "t", ["model_benchmarks.csv"])
    row = _rows(tmp_path / "t" / "model_benchmarks.csv")[0]
    assert row["memory_source"] == "unavailable"
    assert float(row["total_ms"]) > 0


def test_baseline_scaling_and_precisions_write_the_row_schema(tmp_path,
                                                              monkeypatch):
    _small_cnn_specs(monkeypatch)
    tbl.main(["--models", "vit_fallback_cnn", "--batch-size", "1",
              "--iters", "6", "--scaling", "--batch-sizes", "1",
              "--precisions", "float32", "bfloat16", "--out",
              str(tmp_path)] + CPU)
    head = _header(tmp_path / "model_benchmarks.csv")
    assert _header(tmp_path / "precision_comparison.csv") == head
    assert _header(tmp_path / "vit_fallback_cnn_batch_scaling.csv") == head
    prec = _rows(tmp_path / "precision_comparison.csv")
    assert [r["dtype"] for r in prec] == ["float32", "bfloat16"]


def test_batch_scaling_records_oom_and_stops(monkeypatch):
    calls = []

    def fake(name, bs, dtype, **kw):
        calls.append(bs)
        if bs >= 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried")
        return {"model": name, "batch_size": bs, "dtype": dtype}

    monkeypatch.setattr(tbl, "benchmark_model", fake)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    rows = tbl.batch_size_scaling("m", (1, 2, 4, 8), device="cpu")
    assert calls == [1, 2, 4]
    assert rows[-1]["status"] == "oom" and rows[-1]["batch_size"] == 4
    assert "status" not in rows[0]

    def broken(name, bs, dtype, **kw):
        raise RuntimeError("not an oom")

    monkeypatch.setattr(tbl, "benchmark_model", broken)
    with pytest.raises(RuntimeError, match="not an oom"):
        tbl.batch_size_scaling("m", (1,), device="cpu")


@pytest.mark.parametrize("n_thread", [0, 1])
def test_time_chained_returns_a_finite_positive_slope(n_thread):
    a = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    b = torch.eye(128)
    res = timing.time_chained(torch.matmul, a, b, k1=2, k2=6,
                              n_thread=n_thread)
    assert math.isfinite(res.per_iter_ms) and res.per_iter_ms > 0
    assert res.k1 < res.k2 and res.t2_ms >= 0
    assert math.isfinite(res.probe)
    assert res.throughput(4) > 0
    with pytest.raises(ValueError):
        timing.time_chained(torch.matmul, a, b, k1=3, k2=3)


def test_time_fn_and_host_fence():
    t = timing.time_fn(torch.add, torch.ones(4), torch.ones(4), warmup=1,
                       iters=3)
    assert t.iters == 3 and len(t.times_ms) == 3 and t.min_ms >= 0
    assert timing.host_fence({"a": torch.ones(3), "b": [torch.ones(2)]}) == 5
    assert timing.host_fence() == 0.0


def test_try_plot_returns_none_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = [{"size": 64, "dtype": "float32", "tflops": 1.0,
             "peak_tflops": None}]
    assert plots.try_plot(plots.plot_matmul_tflops, rows,
                          tmp_path / "p.png") is None
    assert not (tmp_path / "p.png").exists()


def test_write_csv_takes_the_union_of_columns(tmp_path):
    write_csv(tmp_path / "x" / "a.csv", [{"a": 1}, {"a": 2, "note": "oom"}])
    assert _header(tmp_path / "x" / "a.csv") == ["a", "note"]
    write_csv(tmp_path / "none.csv", [])
    assert not (tmp_path / "none.csv").exists()
