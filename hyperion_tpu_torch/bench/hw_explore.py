"""Hardware exploration: matmul TFLOPS by dtype and memory bandwidth —
`hyperion_tpu/bench/hw_explore.py` on the card.

The reference's Phase-1 notebook: a device report, square matmuls at
1024-8192 for fp32, fp16 and bf16, and a bandwidth sweep of z = x + y
counting 12 bytes an element (two fp32 reads, one write). Each point is
a chain of data-dependent iterations (`utils.timing.time_chained`, each
chain one CUDA graph replayed between CUDA events, the per-iteration
time the slope of two chain lengths), as the reference's jitted chains.

  * The float rows are `torch.matmul`. fp32 runs with TF32 off
    (`torch.backends.cuda.matmul.allow_tf32 = False`, set here): true
    fp32 on the CUDA cores, as the reference asked for with
    `Precision.HIGHEST`.
  * The int8 row is `torch._int_mm` (int8 x int8 -> int32) with the
    reference's requantized carry (round(acc * inv) clipped to int8),
    the card's library rate as XLA's dot is the TPU's; the port's own
    int8 kernel is timed against it in `chip_smoke.py`'s kernels phase.
  * Bandwidth: `torch.lerp(x, y, 0.5)` = (x + y) / 2 in one pass (2
    reads, 1 write), threaded so each iteration reads the last one's
    output. A working set under twice the 50 MB L2 is flagged
    `cache_resident_not_hbm`.

`mfu`/`peak_tflops` are against `utils/chips.py`'s datasheet peaks.

    python -m hyperion_tpu_torch.bench.hw_explore [--sizes ...]
        [--dtypes ...] [--bandwidth-elems ...] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.bench.util import write_csv as _write_csv
from hyperion_tpu_torch.metrics.plots import (
    plot_bandwidth,
    plot_matmul_tflops,
    try_plot,
)
from hyperion_tpu_torch.utils.chips import mfu as chip_mfu
from hyperion_tpu_torch.utils.chips import nominal_peak_tflops
from hyperion_tpu_torch.utils.timing import time_chained

MATMUL_SIZES = (1024, 2048, 4096, 8192)
MATMUL_DTYPES = ("float32", "bfloat16", "float16", "int8")
BANDWIDTH_ELEMS = (10_000_000, 50_000_000, 100_000_000, 250_000_000,
                   500_000_000)
BYTES_PER_ELEM = 12  # 2 fp32 reads + 1 write, the reference's accounting
CACHE_RESIDENT_MB = 100  # twice the H100's 50 MB L2


def device_report(device=None) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return {"backend": "cuda", "device_count": torch.cuda.device_count(),
                "device_kind": props.name, "platform": "gpu",
                "hbm_limit_bytes": int(props.total_memory)}
    return {"backend": "cpu", "device_count": 1, "device_kind": "cpu",
            "platform": "cpu", "hbm_limit_bytes": 0}


def _int8_mm(inv: float):
    def mm(c, b):
        f = torch._int_mm(c, b).float()
        return f.mul_(inv).round_().clamp_(-127, 127).to(torch.int8)

    return mm


def _float_mm(c, b):
    return torch.matmul(c, b)


def matmul_tflops(sizes=MATMUL_SIZES, dtypes=MATMUL_DTYPES, iters: int = 10,
                  device=None) -> list[dict]:
    del iters  # chain lengths are fixed; kept for the reference's CLI
    dev = resolve_device(device)
    graph = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for size in sizes:
        for dtype in dtypes:
            g = torch.Generator(device=dev).manual_seed(size)
            if dtype == "int8":
                a = torch.randint(-127, 128, (size, size), generator=g,
                                  device=dev, dtype=torch.int8)
                # b column-major, the layout cuBLASLt's int8 product
                # takes ("TN"); a row-major operand sends it down a slow
                # path (on an H100, ~135 against ~920 TOP/s at 8192:
                # scripts/profile_torch_decode.py)
                b = torch.randint(-127, 128, (size, size), generator=g,
                                  device=dev, dtype=torch.int8).t()
                mm = _int8_mm(1.0 / (size ** 0.5 * 73.0))
            else:
                dt = getattr(torch, dtype)
                a = torch.randn(size, size, generator=g, device=dev).to(dt)
                # unit scale folded into b outside the chain: the timed
                # iteration is the product alone
                b = (torch.randn(size, size, generator=g, device=dev)
                     / size ** 0.5).to(dt)
                mm = _float_mm
            t = time_chained(mm, a, b, k1=8, k2=24, n_thread=1, graph=graph)
            tflops = (2 * size ** 3 / (t.per_iter_ms / 1e3)) / 1e12
            util = chip_mfu(tflops, dtype, dev)
            rows.append({
                "size": size, "dtype": dtype,
                "time_ms": round(t.per_iter_ms, 4),
                "tflops": round(tflops, 2),
                "peak_tflops": nominal_peak_tflops(dtype, dev),
                "mfu": round(util, 4) if util is not None else None,
                "dispatch_overhead_ms": round(t.overhead_ms, 2),
            })
            del a, b
    return rows


def _half_sum(x, y):
    return torch.lerp(x, y, 0.5)


def memory_bandwidth(elem_counts=BANDWIDTH_ELEMS, iters: int = 10,
                     device=None) -> list[dict]:
    del iters
    dev = resolve_device(device)
    rows = []
    for n in elem_counts:
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn(n, generator=g, device=dev)
        y = torch.randn(n, generator=g, device=dev)
        t = time_chained(_half_sum, x, y, k1=8, k2=24, n_thread=1,
                         graph=dev.type == "cuda")
        gbps = (n * BYTES_PER_ELEM / (t.per_iter_ms / 1e3)) / 1e9
        working_set_mb = n * BYTES_PER_ELEM / 1e6
        rows.append({
            "elements": n, "time_ms": round(t.per_iter_ms, 4),
            "gb_per_s": round(gbps, 2),
            "dispatch_overhead_ms": round(t.overhead_ms, 2),
            "note": ("cache_resident_not_hbm"
                     if working_set_mb < CACHE_RESIDENT_MB else ""),
        })
        del x, y
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="*", default=list(MATMUL_SIZES))
    p.add_argument("--dtypes", nargs="*", default=list(MATMUL_DTYPES))
    p.add_argument("--bandwidth-elems", type=int, nargs="*",
                   default=list(BANDWIDTH_ELEMS))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default="results/torch/benchmarks/hardware")
    p.add_argument("--skip-bandwidth", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    info = device_report(args.device)
    print(f"[hw_explore] {json.dumps(info)}")

    rows = matmul_tflops(args.sizes, args.dtypes, args.iters, args.device)
    for r in rows:
        how = {"float32": " (TF32 off)",
               "int8": " (torch._int_mm, requantized carry)"}.get(
            r["dtype"], "")
        print(f"[hw_explore] matmul {r['size']}^2 {r['dtype']:>9}: "
              f"{r['tflops']:8.2f} TFLOPS ({r['time_ms']:.3f} ms){how}")
    out = Path(args.out)
    _write_csv(out / "precision_results.csv", rows)
    try_plot(plot_matmul_tflops, rows, out / "precision_results.png")

    if not args.skip_bandwidth:
        bw = memory_bandwidth(args.bandwidth_elems, args.iters, args.device)
        for r in bw:
            print(f"[hw_explore] bandwidth {r['elements']:>11,} elems: "
                  f"{r['gb_per_s']:8.2f} GB/s")
        _write_csv(out / "bandwidth_results.csv", bw)
        try_plot(plot_bandwidth, bw, out / "bandwidth_results.png")

    (out / "device_info.json").write_text(json.dumps(info, indent=2))
    print(f"[hw_explore] results in {out}/")


if __name__ == "__main__":
    main()
