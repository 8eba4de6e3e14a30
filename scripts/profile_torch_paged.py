"""The paged-attention kernel's times at the serve path's shapes, on one
CUDA card: the decode tick ([4, 1] at Llama-2-7B heads, bf16), decode
[8, 1] and the [1, 512] prefill window at base 256 at 7B and 70B heads,
in bf16 and fp32 — the cases `chip_smoke.py` times — each against its
plain version, with its plan, registers and spills where the checkout
reports them.

    python3 scripts/profile_torch_paged.py [--root DIR]

`--root` runs the kernel of another checkout of this repo (for
example an older commit unpacked with `git archive`) through that
checkout's own `chip_smoke.py`, so two versions can be compared in one
run on one card: old, new, new, old. Prints one JSON line a case
(`chip_smoke.check_paged`'s record, with `root`). `--plans` (this
checkout only) then times the decode tick and the bf16 prefill window
under other launch plans than `paged_attention.plan` picks — no split,
finer splits, 4-warp blocks for the tick; splits for the prefill — in
turns with the plan's own (plan, others, plan), each checked against
the plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        print("profile_torch_paged: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    cs.emit({"root": str(root), "device": torch.cuda.get_device_name(0)})
    emit = cs.emit
    cs.emit = lambda rec: emit({**rec, "root": root.name})
    for dtype in (torch.bfloat16, torch.float32):
        for H, Hkv, tag in ((32, 32, "7b"), (64, 8, "70b")):
            cs.check_paged(f"decode_{tag}", cs.paged_geometry(
                8, 1, H, Hkv, dtype), dtype, timing=True)
            cs.check_paged(f"prefill_{tag}", cs.paged_geometry(
                1, 512, H, Hkv, dtype, base=[256], seed=2), dtype,
                timing=True)
    bases = np.random.default_rng(cs.SEED + 4).integers(32, 532, 4)
    tick = cs.paged_geometry(4, 1, 32, 32, torch.bfloat16, base=bases,
                             seed=5)
    cs.check_paged("decode_tick_S4", tick, torch.bfloat16, timing=True)
    if args.plans:
        prefill = cs.paged_geometry(1, 512, 32, 32, torch.bfloat16,
                                    base=[256], seed=2)
        compare_plans(cs, "decode_tick_S4", tick, [(1, 1, 1, 1024),
                                                   (1, 1, 32, 32),
                                                   (4, 1, 8, 128)])
        compare_plans(cs, "prefill_7b", prefill, [(4, 8, 2, 512),
                                                  (4, 8, 4, 256)])
    print(json.dumps({"done": True}), flush=True)
    return 0


def compare_plans(cs, name, geo, others) -> None:
    """Kernel ms of `geo` under `paged_attention.plan`'s plan and under
    each (warps, row_tiles, n_splits, split_len) of `others`, in turns:
    the plan's, the others, the plan's again."""
    from hyperion_tpu_torch.ops import paged_attention as pa

    q, kp, vp, bt, base = geo
    nbytes, _ = cs.paged_cost(q, kp, bt, base)
    ref = pa.paged_attention_plain(*geo).float()
    atol, rtol = cs.ATTN_TOL[q.dtype]
    own = pa.plan_for(q, kp, bt)
    for p in [own, *(pa.Plan(*o) for o in others), own]:
        out = pa._launch(*geo, p=p).float()
        ok = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
        cs.emit({"case": name, "plan": dataclasses.asdict(p),
                 "planned": p == own, "ok": ok, "kernel_ms": cs.time_ms(
                     lambda *a: pa._launch(*a, p=p), geo, nbytes)})


if __name__ == "__main__":
    sys.exit(main())
