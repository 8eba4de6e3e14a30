"""Where the port's Llama LoRA train step time goes on the card:
Llama-2-7B (full widths and depth, bf16, seeded random weights), LoRA
r 16 on q/k/v/o, remat "full", seq 4096, batch 1, jit+pallas, through
`train_llama` (chip_smoke.py's llama_train configuration), under
`torch.profiler`.

    python3 scripts/profile_torch_llama.py

Trains STEPS steps without validation under the profiler and reads the
device time of every CUDA kernel; the first step (cuBLAS and allocator
warm-up) is in the totals, so the per-step figures are a slight upper
bound. Prints JSON lines: the step time p50 (CUDA events, from the
same run), kernel time and launches per step and their share of the
step p50 (the card's busy share), device time per step grouped by what
the kernel does, and the top N kernels. Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOP = 12  # kernels listed one by one
STEPS = 4  # profiled steps

GROUPS = (  # first match wins, on the lowercased kernel name
    ("memcpy / memset", ("memcpy", "memset")),
    ("flash forward (hand-written)", ("flash_fwd_kernel",)),
    ("flash dq (hand-written)", ("flash_dq_kernel",)),
    ("flash dk/dv (hand-written)", ("flash_dkv_kernel",)),
    ("fused_rmsnorm backward (hand-written)", ("rmsnorm_bwd_",
                                               "rmsnorm_dw_kernel")),
    ("fused_rmsnorm (hand-written)", ("rmsnorm_kernel", "rmsnorm_warp_kernel",
                                      "rmsnorm_block_kernel")),
    ("fused_softmax_xent fwd+bwd (hand-written)", ("ce_fwd_kernel",
                                                   "ce_bwd_kernel")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")),
    ("AdamW and grad norm", ("adam", "multi_tensor", "foreach")),
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
        print("profile_torch_llama: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from hyperion_tpu_torch.train.trainer import train_llama

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = chip_smoke.llama_train_config(ROOT / "build" /
                                        "profile_torch_llama", steps=STEPS)
    cfg.train.validate = False
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        res = train_llama(cfg)
    step_p50 = float(np.percentile(res.step_ms, 50))
    groups: dict[str, float] = {}
    rows = []
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        ms = (e.self_cuda_time_total if us is None else us) / 1e3 / STEPS
        label = group_of(e.key)
        groups[label] = groups.get(label, 0.0) + ms
        rows.append((ms, e.count / STEPS, e.key))
        if label != "memcpy / memset":
            launches += e.count
    kernel_ms = sum(v for k, v in groups.items() if k != "memcpy / memset")
    rows.sort(reverse=True)
    emit({"device": torch.cuda.get_device_name(0),
          "step_ms": res.step_ms, "step_ms_p50": step_p50,
          "tokens_per_s": 4096 / (step_p50 / 1e3), "profiled_steps": STEPS,
          "kernel_ms_per_step": kernel_ms,
          "kernel_launches_per_step": launches / STEPS,
          "kernel_share_of_step_p50": kernel_ms / step_p50})
    emit({"groups_ms_per_step": dict(sorted(groups.items(),
                                            key=lambda kv: -kv[1]))})
    for ms, calls, name in rows[:TOP]:
        emit({"kernel": name[:120], "ms_per_step": ms,
              "calls_per_step": calls})
    return 0


if __name__ == "__main__":
    sys.exit(main())
