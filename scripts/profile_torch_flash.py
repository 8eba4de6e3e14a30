"""The fp32 flash-attention kernels' times against SDPA on one CUDA card:
the forward and the whole backward (the dq and dk/dv launches, delta
included) at [2, 1024, 8, 128] fp32, causal and full, and at
[1, 4096, 8, 64] fp32 causal (the language_ddp TransformerLM's heads at
the length where `impl="auto"` picks flash under `precision="fp32"`).

    python3 scripts/profile_torch_flash.py [--root DIR]

Each of the forward and the backward is timed in turns with
`scaled_dot_product_attention` over the same boolean mask: library,
kernel, kernel, library. Each case is checked against the plain versions
first (o and lse within 2e-5, gradients within 2e-4), and its bounds are
this checkout's `chip_smoke.bound` (fp32: three TF32 passes at the dense
TF32 rate). For a causal case SDPA is also timed once with
`is_causal=True`, which takes no mask.

`--root` runs the kernels of another checkout of this repo (for example
an older commit unpacked with `git archive`): its `hyperion_tpu_torch`
is imported and built, while the timing and the inputs are this
checkout's, so two versions compare in one call on one card when the
script runs old, new, new, old. Prints one JSON line a case, with
`root`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
CASES = (("fp32_causal", (2, 1024, 8, 128), True),
         ("fp32_full", (2, 1024, 8, 128), False),
         ("fp32_causal_4096_d64", (1, 4096, 8, 64), True))


def load_smoke():
    """This checkout's chip_smoke.py (timing, inputs, bounds), under its
    own name, so that `--root`'s package is the one imported."""
    spec = importlib.util.spec_from_file_location("smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_case(cs, fa, name, shape, causal) -> dict:
    B, T, H, D = shape
    q, k, v, do, pad = cs.flash_case(B, T, H, D, torch.float32, 0.0,
                                     cs.SEED + 30)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    checks = [cs.flash_close(o, ro, q.dtype, "o"),
              cs.flash_close(lse, rlse, q.dtype, "lse")]
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    checks += [cs.flash_close(a, r, q.dtype, w)
               for a, r, w in zip(grads, refs, ("dq", "dk", "dv"))]
    del ro, rlse, refs, grads
    n = q.numel() * q.element_size()
    stats = B * H * T * 4
    pairs = cs.flash_pairs(B, T, causal, pad)
    keep = torch.ones(T, T, dtype=torch.bool, device="cuda")
    if causal:
        keep = torch.tril(keep)
    mask4 = keep[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    side = cs.side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the graph's stream
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_o = sdpa(*(t.transpose(1, 2) for t in leaves), attn_mask=mask4)
    nf, nb = 4 * n + stats, 8 * n + stats
    timers = {
        ("fwd", "library"): lambda: cs.time_ms(
            lambda a, b, c: sdpa(a.transpose(1, 2), b.transpose(1, 2),
                                 c.transpose(1, 2), attn_mask=mask4),
            (q, k, v), nf),
        ("fwd", "kernel"): lambda: cs.time_ms(
            lambda a, b, c: fa._launch_fwd(a, b, c, None, causal, True),
            (q, k, v), nf),
        ("bwd", "library"): lambda: cs.replay_ms(
            lambda lo, a, b, c, g: torch.autograd.grad(
                lo, (a, b, c), g, retain_graph=True),
            [(lib_o, *leaves, do.transpose(1, 2))]),
        ("bwd", "kernel"): lambda: cs.time_ms(
            lambda a, b, c, oo, ll, g: fa.flash_attention_bwd(
                a, b, c, oo, ll, g, causal=causal),
            (q, k, v, o, lse, do), nb),
    }
    rec = {"case": name, "shape": list(shape), "dtype": "float32",
           "causal": causal, "ok": all(ok for ok, _ in checks),
           "max_abs_err": {w: e for w, (_, e) in
                           zip(("o", "lse", "dq", "dk", "dv"), checks)}}
    for part in ("fwd", "bwd"):
        for who in ("library", "kernel", "kernel", "library"):
            rec.setdefault(f"{part}_{who}_ms", []).append(
                timers[(part, who)]())
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = cs.bound(
        nf, 4.0 * D * H * pairs, torch.float32)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = cs.bound(
        nb, 10.0 * D * H * pairs, torch.float32)
    if causal:
        rec["fwd_library_is_causal_ms"] = cs.time_ms(
            lambda a, b, c: sdpa(a.transpose(1, 2), b.transpose(1, 2),
                                 c.transpose(1, 2), is_causal=True),
            (q, k, v), nf)
    rec["attrs"] = {w: fa.kernel_attrs(w, D, torch.float32)
                    for w in ("fwd", "dq", "dkv")}
    del leaves, lib_o
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("profile_torch_flash: needs a CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    sys.path.insert(0, str(root))
    from hyperion_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    cs.emit({"root": str(root), "device": torch.cuda.get_device_name(0)})
    ok = True
    for name, shape, causal in CASES:
        rec = profile_case(cs, fa, name, shape, causal)
        cs.emit({**rec, "root": root.name})
        ok = ok and rec["ok"]
    print(json.dumps({"done": True, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
