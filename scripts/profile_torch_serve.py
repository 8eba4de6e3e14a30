"""Where the port's serving time goes on the card: Llama-2-7B (bf16,
seeded random weights) behind the continuous-batching engine, the same
requests as chip_smoke.py's serve phase (or, with `--features`, its
serve_features waves and engine), under `torch.profiler`.

    python3 scripts/profile_torch_serve.py [--features] [--root DIR]

Serves the requests twice, each time on a fresh engine over the same
weights: once plain, for the wall time, and once under the profiler,
for the device time of every CUDA kernel — CUPTI lists the kernels a
CUDA graph replay runs one by one, so the sums hold whether the engine
captured its surfaces or ran them eagerly. Prints JSON lines: the
walls, the plain run's decode tick, TPOT and TTFT p50 and peak memory,
the compile tier (graphs per surface, each graph's build seconds, the
graphs' pool), the device busy share (kernel time of the profiled run
over the plain run's wall), device time grouped by what the kernel
does (the hand-written kernels — paged attention's split and combine
kernels in one group — matmuls, the rest), and the top N kernels.
`--root` serves with another checkout's package (for example the
parent's, unpacked under `build/` by `git archive`) on this checkout's
requests. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
TOP = 15  # kernels listed one by one

GROUPS = (  # first match wins, on the lowercased kernel name
    ("paged_attention (hand-written)", ("paged_attention_kernel",
                                        "paged_attention_combine_kernel")),
    ("fused_rmsnorm (hand-written)", ("rmsnorm_kernel", "rmsnorm_warp_kernel",
                                      "rmsnorm_block_kernel", "rmsnorm_bwd_",
                                      "rmsnorm_dw_kernel")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")),
    ("kv scatter / gather / index", ("index", "scatter", "gather")),
    ("copies and casts", ("copy", "cast", "convert")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other elementwise / reductions"


def emit(obj) -> None:
    print(json.dumps(obj, separators=(",", ":")), flush=True)


def _chip_smoke():
    """This checkout's chip_smoke (its requests and configs), whatever
    package `--root` puts first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose hyperion_tpu_torch serves")
    ap.add_argument("--features", action="store_true",
                    help="serve_features' engine and three waves")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    from hyperion_tpu_torch.models.llama import Llama, llama2_7b_config
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.server import serve_jsonl

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama2_7b_config(dtype="bfloat16", norm_impl="pallas")
    model = Llama(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    reqs = cs.serve_requests(np.random.default_rng(cs.SEED + 3))
    if args.features:
        waves = cs.serve_feature_waves(reqs, np.random.default_rng(
            cs.SEED + 7))
        ecfg = EngineConfig(slots=4, max_len=1024, block_size=16, spec_k=4,
                            draft="ngram", prefill_chunk=256,
                            num_blocks=96, host_cache_mb=2048)
        warm = [600]
    else:
        waves = [reqs]
        ecfg = EngineConfig(slots=4, max_len=1024, block_size=16)
        warm = [500]

    def serve(profiler=None):
        eng = Engine(model, ecfg, device="cuda")
        eng.warmup(warm)
        eng.forwards = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profiler if profiler is not None \
                else contextlib.nullcontext():
            for wave in waves:
                summary = serve_jsonl(eng, io.StringIO(
                    "".join(json.dumps(r) + "\n" for r in wave)),
                    io.StringIO())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reg = eng.metrics.reg
        tier = getattr(eng, "tier", None)  # None: an eager engine
        return wall, {
            "ticks": summary["ticks"], "forwards": eng.forwards,
            "tokens": summary["tokens"],
            "tick_ms_p50": reg.histogram("serve_tick_ms").percentile(50),
            "tpot_ms_p50": summary["tpot_ms"].get("p50"),
            "ttft_ms_p50": summary["ttft_ms"].get("p50"),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "graphs": None if tier is None else len(tier.graphs),
            "compile_stats": None if tier is None else eng.compile_stats(),
            "capture_s": None if tier is None else tier.capture_seconds(),
            "graph_pool_bytes": None if tier is None else tier.pool_bytes(),
            "recompiles": None if tier is None else eng.ledger.recompiles,
        }

    wall, rec = serve()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall_prof, _ = serve(prof)
    rows = []
    graph_launches = 0
    for e in prof.key_averages():
        if e.key == "cudaGraphLaunch":
            graph_launches += e.count
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their device time is their kernels'
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups: dict[str, float] = {}
    for name, ms, _ in rows:
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    emit({"device": torch.cuda.get_device_name(0), "root": root.name,
          "run": "serve_features" if args.features else "serve",
          "layers": cfg.n_layers,
          "serve_wall_ms": wall * 1e3,
          "serve_wall_profiled_ms": wall_prof * 1e3,
          "kernel_ms": device_ms,
          "device_busy_share": device_ms / (wall * 1e3),
          "graph_launches_profiled": graph_launches, **rec})
    emit({"groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))})
    for name, ms, count in rows[:TOP]:
        emit({"kernel": name[:120], "device_ms": ms, "calls": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
