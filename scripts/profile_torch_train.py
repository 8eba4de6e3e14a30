"""Where the port's train step time goes on the card: `language_ddp`
(the TransformerLM at its published widths, bf16, jit+pallas, batch 32,
seq 128) through `train_language_model`, under `torch.profiler`.

    python3 scripts/profile_torch_train.py [--long] [--root DIR]

`--long` takes chip_smoke.py's long-context config instead (seq 4096,
batch 8, where attention runs the flash kernels at head_dim 64).
Trains twice, from the same seed: once plain (50 steps and validation,
chip_smoke.py's train phase; with `--long` its 30 steps and 30
validation batches), for the step time p50 by CUDA events, and
once for 10 steps without validation under the profiler, for the device
time of every CUDA kernel. Prints JSON lines: the step p50, the kernel
time and launches per step and their share of the step p50 (the card's
busy share), device time per step grouped by what the kernel does, the
top N kernels, and the operators a step calls on a tensor the size of
the loss's logits view or larger ([B, T-1, V] elements: the casts of the
logits, the loss's kernels, any slice backward's zero-fill and copy),
by name and shape. The profiled run's set-up (weight init, the export's
copies out) is in its totals too: the memcpy group and a few init
kernels. Needs one CUDA card.

`--root` trains with another checkout's `hyperion_tpu_torch` (an older
commit unpacked with `git archive`) on this checkout's configs, so two
versions compare in one call when the script runs old, new, new, old.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

TOP = 12  # kernels listed one by one
STEPS = 10  # profiled steps

GROUPS = (  # first match wins, on the lowercased kernel name
    ("memcpy / memset", ("memcpy", "memset")),
    ("flash forward (hand-written)", ("flash_fwd_kernel",)),
    ("flash dq (hand-written)", ("flash_dq_kernel",)),
    ("flash dk/dv (hand-written)", ("flash_dkv_kernel",)),
    ("fused_softmax_xent fwd+bwd (hand-written)", ("ce_fwd_kernel",
                                                   "ce_bwd_kernel")),
    ("fused_layernorm (hand-written)", ("layernorm",)),  # both kernels
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")),
    ("AdamW and grad norm", ("adam", "multi_tensor", "foreach")),
    ("embedding backward", ("embedding", "sort", "segment", "unique")),
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


def logits_sized_ops(prof, numel: int) -> dict[str, float]:
    """Calls a step of every operator with an input of at least `numel`
    elements, keyed by name and that input's shape."""
    out: dict[str, float] = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        big = [s for s in e.input_shapes or ()  # tensors' shapes only
               if s and all(isinstance(d, int) for d in s)
               and math.prod(s) >= numel]
        if big:
            key = f"{e.key} {big[0]}"
            out[key] = out.get(key, 0.0) + e.count / STEPS
    return dict(sorted(out.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--long", action="store_true",
                    help="chip_smoke.long_train_config: seq 4096, batch 8")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose hyperion_tpu_torch trains")
    args = ap.parse_args()
    long, root = args.long, args.root.resolve()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # this checkout's configs, before --root is on the path

    sys.path.insert(0, str(root))
    from hyperion_tpu_torch.train import trainer

    if not Path(trainer.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {trainer.__file__}, not from {root}")
    train_language_model = trainer.train_language_model
    torch.backends.cuda.matmul.allow_tf32 = False
    config = chip_smoke.long_train_config if long else chip_smoke.train_config
    base = ROOT / "build" / "profile_torch_train" / root.name
    res = train_language_model(config(base / "plain"))
    step_p50 = float(np.percentile(res.step_ms, 50))
    vocab = res.model.cfg.vocab_size
    del res

    cfg = config(base / "profiled", steps=STEPS)
    cfg.train.validate = False
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        record_shapes=True)
    with prof:
        train_language_model(cfg)
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
    tokens = cfg.train.batch_size * cfg.train.seq_len
    emit({"device": torch.cuda.get_device_name(0), "root": root.name,
          "config": "long" if long else "default", "tokens_per_step": tokens,
          "step_ms_p50": step_p50, "tokens_per_s": tokens / (step_p50 / 1e3),
          "profiled_steps": STEPS, "kernel_ms_per_step": kernel_ms,
          "kernel_launches_per_step": launches / STEPS,
          "kernel_share_of_step_p50": kernel_ms / step_p50})
    emit({"groups_ms_per_step": dict(sorted(groups.items(),
                                            key=lambda kv: -kv[1]))})
    for ms, calls, name in rows[:TOP]:
        emit({"kernel": name[:120], "ms_per_step": ms,
              "calls_per_step": calls})
    emit({"logits_sized_ops_per_step": logits_sized_ops(
        prof, cfg.train.batch_size * (cfg.train.seq_len - 1) * vocab)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
