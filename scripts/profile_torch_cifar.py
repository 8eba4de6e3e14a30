"""Where the port's cifar step time goes on the card: ResNet-18 at its
published widths (CIFAR stem), bf16 over fp32 masters, batch 64, lr
1e-3, through `cli.main`'s job config and `train_cifar_model`, under
`torch.profiler`.

    python3 scripts/profile_torch_cifar.py

Writes the synthetic CIFAR-10 split (5000 train images) as recordio
with `data.prepare`'s `prepare_cifar`, as chip_smoke.py's prepare phase
does, then trains twice from the same seed: once plain (one epoch of
78 steps, no validation), for the step time p50 by CUDA events, and
once for 10 steps under the profiler, for the device time and the
launches of every CUDA kernel. Prints JSON lines: the step p50, the
kernel time and launches per step and their share of the step p50 (the
card's busy share), device time per step grouped by what the kernel
does, the top kernels, and the operators a step calls most. The
profiled run's set-up (weight init, the checkpoint's snapshot) is in
its totals too: the memcpy group and a few init kernels. Needs one
CUDA card.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOP = 12  # kernels and operators listed one by one
STEPS = 10  # profiled steps

GROUPS = (  # first match wins, on the lowercased kernel name
    ("memcpy / memset", ("memcpy", "memset")),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "dgrad",
                             "wgrad", "winograd", "fft", "nhwc", "sm90",
                             "cutlass", "nvjet")),
    ("matmul (cuBLAS)", ("gemm", "gemv")),
    ("AdamW and grad norm", ("adam", "multi_tensor", "foreach")),
    ("reductions (BatchNorm statistics, pooling)", ("reduce", "sum", "mean",
                                                    "norm")),
    ("copies and casts", ("copy", "cast", "convert")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def emit(obj) -> None:
    print(json.dumps(obj, separators=(",", ":")), flush=True)


def job_config(base: Path, data: Path, steps: int):
    from hyperion_tpu_torch.cli import main as cli

    args = cli.build_parser().parse_args([
        "--model", "cifar", "--epochs", "1", "--base_dir", str(base),
        "--data_dir", str(data), "--steps-per-epoch", str(steps),
        "--no-validate", "--no-telemetry"])
    return cli.make_config(args, "cifar")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_cifar: needs a CUDA device", file=sys.stderr)
        return 1
    from hyperion_tpu_torch.data.prepare import prepare_cifar
    from hyperion_tpu_torch.train.trainer import train_cifar_model

    base = ROOT / "build" / "profile_torch_cifar"
    shutil.rmtree(base, ignore_errors=True)
    prepare_cifar(base / "data", verbose=False)
    cfg = job_config(base / "plain", base / "data", 78)
    batch = cfg.train.batch_size
    res = train_cifar_model(cfg, device="cuda")
    step_ms = np.asarray(res.step_ms)
    step_p50 = float(np.percentile(step_ms, 50))
    del res

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    with prof:
        train_cifar_model(job_config(base / "profiled", base / "data",
                                     STEPS), device="cuda")
    groups: dict[str, float] = {}
    launches_by_group: dict[str, float] = {}
    kernels, ops = [], []
    launches = 0
    events = prof.key_averages()
    # a record_function range (AdamW's step) shows on the device too,
    # under its host name: a span, not a kernel
    host_names = {e.key for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key in host_names:
                continue
            us = getattr(e, "self_device_time_total", None)
            ms = (e.self_cuda_time_total if us is None else us) / 1e3 / STEPS
            label = group_of(e.key)
            groups[label] = groups.get(label, 0.0) + ms
            launches_by_group[label] = (launches_by_group.get(label, 0.0)
                                        + e.count / STEPS)
            kernels.append((ms, e.count / STEPS, e.key))
            if label != "memcpy / memset":
                launches += e.count
        elif e.key.startswith("aten::"):
            ops.append((e.count / STEPS, e.key))
    kernel_ms = sum(v for k, v in groups.items() if k != "memcpy / memset")
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    emit({"device": torch.cuda.get_device_name(0), "batch": batch,
          "step_ms_p50": step_p50, "step_ms_min": float(step_ms.min()),
          "step_ms_max": float(step_ms.max()), "steps": len(step_ms),
          "images_per_s": batch / (step_p50 / 1e3),
          "profiled_steps": STEPS, "kernel_ms_per_step": kernel_ms,
          "kernel_launches_per_step": launches / STEPS,
          "kernel_share_of_step_p50": kernel_ms / step_p50})
    emit({"groups_ms_per_step": dict(sorted(groups.items(),
                                            key=lambda kv: -kv[1])),
          "groups_launches_per_step": dict(sorted(
              launches_by_group.items(), key=lambda kv: -kv[1]))})
    for ms, calls, name in kernels[:TOP]:
        emit({"kernel": name[:120], "ms_per_step": ms,
              "calls_per_step": calls})
    emit({"aten_calls_per_step": {k: c for c, k in ops[:2 * TOP]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
