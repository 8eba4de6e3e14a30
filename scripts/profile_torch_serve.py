"""Where the port's serving time goes on the card: Llama-2-7B (bf16,
seeded random weights) behind the continuous-batching engine, the same
8 requests as chip_smoke.py's serve phase, under `torch.profiler`.

    python3 scripts/profile_torch_serve.py

Serves the requests twice, each time on a fresh engine over the same
weights: once plain, for the wall time, and once under the profiler,
for the device time of every CUDA kernel. Prints JSON lines: the walls,
the plain run's decode tick p50, the device busy share (kernel time of
the profiled run over the plain run's wall), device time grouped by
what the kernel does (the hand-written kernels — paged attention's
split and combine kernels in one group — matmuls, the rest), and the
top N kernels. Needs one CUDA card.
"""

from __future__ import annotations

import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from hyperion_tpu_torch.models.llama import Llama, llama2_7b_config
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.server import serve_jsonl

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama2_7b_config(dtype="bfloat16", norm_impl="pallas")
    model = Llama(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
    reqs = chip_smoke.serve_requests(
        np.random.default_rng(chip_smoke.SEED + 3))

    def serve(profiler=None):
        eng = Engine(model, EngineConfig(slots=4, max_len=1024,
                                         block_size=16), device="cuda")
        eng.warmup([500])
        eng.forwards = 0
        infile = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiler is None:
            summary = serve_jsonl(eng, infile, io.StringIO())
        else:
            with profiler:
                summary = serve_jsonl(eng, infile, io.StringIO())
        torch.cuda.synchronize()
        tick_p50 = eng.metrics.reg.histogram("serve_tick_ms").percentile(50)
        return time.perf_counter() - t0, summary, eng.forwards, tick_p50

    wall, summary, forwards, tick_p50 = serve()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall_prof, _, _, _ = serve(prof)
    rows = []
    for e in prof.key_averages():
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
    emit({"device": torch.cuda.get_device_name(0), "layers": cfg.n_layers,
          "serve_wall_ms": wall * 1e3,
          "serve_wall_profiled_ms": wall_prof * 1e3,
          "kernel_ms": device_ms,
          "device_busy_share": device_ms / (wall * 1e3),
          "ticks": summary["ticks"], "tick_ms_p50": tick_p50,
          "forwards": forwards,
          "tokens": summary["tokens"],
          "tpot_ms_p50": summary["tpot_ms"].get("p50")})
    emit({"groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))})
    for name, ms, count in rows[:TOP]:
        emit({"kernel": name[:120], "device_ms": ms, "calls": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
