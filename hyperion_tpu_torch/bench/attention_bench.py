"""Long-sequence attention scaling: materialized scores against the flash
kernels — `hyperion_tpu/bench/attention_bench.py` on the card.

Per sequence length, forward and train (forward + dq/dk/dv) time and
memory of `ops.attention.dot_product_attention` at

  impl="xla"     the plain formulation: the [T, T] scores materialized
                 in device memory (and kept for the backward);
  impl="pallas"  the port's flash kernels (`ops/csrc/flash_attention.cu`:
                 streamed K/V tiles, online softmax, O(T) residuals).

for the gpt2 (D 64) and llama (D 128) geometries, causal. Timing is
`utils.timing.time_chained` with (q, k, v) threaded through each
iteration (the train step folds dq, dk and dv back into all three, so
every backward kernel runs), each chain one CUDA graph replayed between
CUDA events. Memory is the allocator's peak above the inputs over the
row (`torch.cuda.max_memory_allocated` after a reset): the card has no
per-program analysis like XLA's. A row that does not fit records
status "oom"; any other failure records status "error" and the run
exits 1.

    python -m hyperion_tpu_torch.bench.attention_bench [--seqs ...]
        [--impls xla pallas] [--modes fwd train] [--geometries ...]
        [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
from pathlib import Path

import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.bench.util import write_csv
from hyperion_tpu_torch.ops.attention import dot_product_attention
from hyperion_tpu_torch.utils.timing import time_chained

# (batch, heads, head_dim) per geometry
GEOMETRIES = {
    "gpt2": (1, 12, 64),
    "llama": (1, 32, 128),
}


def kernel_rev() -> str:
    """A stamp of the flash kernels' source, so a comparison can tell
    rows of different kernel revisions apart."""
    src = Path(__file__).resolve().parents[1] / "ops" / "csrc" / \
        "flash_attention.cu"
    return "sha256:" + hashlib.sha256(src.read_bytes()).hexdigest()[:12]


def _qkv(seq: int, dtype: str, geometry: str, dev):
    batch, heads, head_dim = GEOMETRIES[geometry]
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / head_dim ** 0.25  # unit-variance logits at any seq
    dt = getattr(torch, dtype)
    return tuple((torch.randn(batch, seq, heads, head_dim, generator=g,
                              device=dev) * scale).to(dt) for _ in range(3))


def _attn_flops(seq: int, backward: bool, geometry: str) -> float:
    """Causal-aware: QK^T and PV are 2*B*H*T^2*D flops each, halved by
    causality; the backward redoes both and adds dq/dk/dv (2.5x)."""
    batch, heads, head_dim = GEOMETRIES[geometry]
    fwd = 2 * 2 * batch * heads * seq * seq * head_dim * 0.5
    return fwd * 3.5 if backward else fwd


def _fwd_step(impl: str):
    def step(q, k, v):
        with torch.no_grad():
            o = dot_product_attention(q, k, v, causal=True, impl=impl)
        return o, k, v

    return step


def _train_step(impl: str):
    def step(q, k, v):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        o = dot_product_attention(*ins, causal=True, impl=impl)
        dq, dk, dv = torch.autograd.grad((o.float() ** 2).sum(), ins)
        eps = 1e-30
        return (q - eps * dq.to(q.dtype), k - eps * dk.to(k.dtype),
                v - eps * dv.to(v.dtype))

    return step


def benchmark_attention(seq: int, impl: str, mode: str = "train",
                        dtype: str = "bfloat16", k1: int = 4, k2: int = 12,
                        geometry: str = "gpt2", device=None) -> dict:
    """One row: `mode` "fwd" (inference) or "train" (fwd+bwd)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    batch, heads, head_dim = GEOMETRIES[geometry]
    row = {"seq": seq, "impl": impl, "mode": mode, "dtype": dtype,
           "geometry": geometry, "batch": batch, "heads": heads,
           "head_dim": head_dim, "kernel_rev": kernel_rev()}
    try:
        q, k, v = _qkv(seq, dtype, geometry, dev)
        step = (_fwd_step if mode == "fwd" else _train_step)(impl)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        res = time_chained(step, q, k, v, k1=k1, k2=k2, n_thread=3,
                           graph=cuda)
        temp = ((torch.cuda.max_memory_allocated(dev) - base) / 1e9
                if cuda else float("nan"))
        tflops = (_attn_flops(seq, mode == "train", geometry)
                  / (res.per_iter_ms / 1e3) / 1e12)
        row.update(status="ok", per_iter_ms=round(res.per_iter_ms, 3),
                   achieved_tflops=round(tflops, 4),
                   temp_memory_gb=round(temp, 4),
                   dispatch_overhead_ms=round(res.overhead_ms, 2))
    except Exception as e:  # noqa: BLE001 — an OOM row is the finding
        oom = isinstance(e, torch.cuda.OutOfMemoryError)
        msg = (str(e).splitlines()[0] if str(e) else repr(e))[:160]
        row.update(status="oom" if oom else "error",
                   per_iter_ms=float("nan"), achieved_tflops=float("nan"),
                   temp_memory_gb=float("nan"),
                   dispatch_overhead_ms=float("nan"), note=msg)
    finally:
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
    return row


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seqs", type=int, nargs="*",
                   default=[1024, 2048, 4096, 8192, 16384])
    p.add_argument("--impls", nargs="*", default=["xla", "pallas"])
    p.add_argument("--modes", nargs="*", default=["fwd", "train"])
    p.add_argument("--geometries", nargs="*", default=["gpt2", "llama"],
                   choices=sorted(GEOMETRIES))
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--out", default="results/torch/benchmarks/attention")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    rows: list[dict] = []
    # seq-major: both impls at each T land before the next T
    for seq in args.seqs:
        for geometry in args.geometries:
            for mode in args.modes:
                for impl in args.impls:
                    row = benchmark_attention(seq, impl, mode, args.dtype,
                                              geometry=geometry,
                                              device=args.device)
                    rows.append(row)
                    write_csv(out / "attention_scaling.csv", rows)
                    print(f"[attention] {json.dumps(row)}")
    print(f"[attention] results in {out}/")
    # "oom" is a finding; "error" means the measurement broke
    return 1 if any(r["status"] == "error" for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
