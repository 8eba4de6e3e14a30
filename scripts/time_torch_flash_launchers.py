"""The flash kernels' three launchers alone on one CUDA card: the forward,
dq (delta included) and dk/dv, each timed twice, full and causal, at one
shape in fp32 or bf16, with the kernels' registers and spill bytes and
their errors against the plain versions. Quicker than
`scripts/profile_torch_flash.py` (no SDPA turns, one shape): the tool for
sweeping variants of one kernel.

    python3 scripts/time_torch_flash_launchers.py [--root DIR]
        [--shape 2,1024,8,256] [--dtype float32]

`--root` times another checkout's `hyperion_tpu_torch` (a variant copied
under `build/variants/<name>/` and edited, or an older commit unpacked
with `git archive`) on this checkout's inputs and timing
(`chip_smoke.time_ms`, `chip_smoke.flash_case`); run this, variant,
variant, this in one call. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--shape", default="2,1024,8,256")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_flash_launchers: needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from hyperion_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    B, T, H, D = (int(x) for x in args.shape.split(","))
    dtype = getattr(torch, args.dtype)
    out = {"root": root.name, "shape": [B, T, H, D], "dtype": args.dtype,
           "device": torch.cuda.get_device_name(0)}
    for causal in (False, True):
        q, k, v, do, _ = cs.flash_case(B, T, H, D, dtype, 0.0, cs.SEED + 30)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        dims, pad, ins = fa._bwd_inputs(q, k, v, o, lse, do, None)
        dq, delta = fa._launch_dq(dims, pad, *ins, causal)
        dk, dv = fa._launch_dkv(dims, pad, *ins, delta, causal)
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
        n = q.numel() * q.element_size()
        stats = B * H * T * 4
        times = {
            "fwd": lambda: cs.time_ms(
                lambda a, b, c: fa._launch_fwd(a, b, c, None, causal, True),
                (q, k, v), 4 * n + stats),
            "dq": lambda: cs.time_ms(
                lambda *a: fa._launch_dq(dims, pad, *a, causal), ins,
                6 * n + 2 * stats),
            "dkv": lambda: cs.time_ms(
                lambda *a: fa._launch_dkv(dims, pad, *a, causal),
                (*ins, delta), 6 * n + 2 * stats)}
        out["causal" if causal else "full"] = {
            **{w: [t() for _ in range(2)] for w, t in times.items()},
            "max_abs_err": {w: float((a.float() - r.float()).abs().max())
                            for w, a, r in zip(("dq", "dk", "dv"),
                                               (dq, dk, dv), refs)}}
        del q, k, v, do, o, lse, ins, dq, dk, dv, refs
    out["attrs"] = {w: fa.kernel_attrs(w, D, dtype)
                    for w in ("fwd", "dq", "dkv")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
