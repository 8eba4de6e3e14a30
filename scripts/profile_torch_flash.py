"""The flash-attention kernels' times against SDPA on one CUDA card: the
forward and the whole backward (the dq and dk/dv launches, delta
included), all causal but one. bf16: [1, 4096, 8, 64] and
[1, 4096, 8, 32] (the D 64 Hopper kernels, D 32 zero-padded to them),
[8, 4096, 4, 64] with the ragged key padding of the language_ddp
synthetic split (chip_smoke.py's long train phase: d 256, 4 heads, seq
4096, batch 8), and the Llama-2-7B train step [1, 4096, 32, 128] with
its last 1024 keys padding (the D 128 Hopper kernels). fp32: [2, 1024,
8, 128] causal and full, and [1, 4096, 8, 64] (the split-TF32 kernels).
Head dim 256: bf16 [1, 4096, 8, 256] causal with the Llama step's
masks and without padding, [2, 4096, 4, 256] with the ragged padding
(chip_smoke.py's lm_d256 step). The head dims between instantiations at
one shape, [2, 1000, 8, D] causal with the last 100 keys of each row
padding: D 32 (the D 64 kernels at width 32), 80 and 96 (kernels of
their own), 128, 160 and 192 (the D 256 kernels at width D) and 256.
fp32 [2, 1024, 8, 256] causal and full. Past 256 (the wide kernels):
[2, 4096, 2, 512] causal with the ragged padding (chip_smoke.py's
lm_d512 layer) in fp32 and bf16, fp32 [2, 1024, 4, 512] full, and fp32
[2, 2048, 1, 2304] causal with the ragged padding (past 2048: the fp32
kernels in two passes).

    python3 scripts/profile_torch_flash.py [--root DIR] [--cases a,b]
        [--plain]

Each of the forward and the backward is timed in turns with
`scaled_dot_product_attention` over the same boolean mask: library,
kernel, kernel, library. For a causal case SDPA with `is_causal=True`
(no mask) joins the turns: library, is_causal, kernel, kernel,
is_causal, library; with key padding that call leaves the padding out,
so it computes less than the kernel does and is a yardstick only.
Then the dq and dk/dv launchers alone, twice each (`dq_kernel_ms`,
`dkv_kernel_ms`).
Each case is checked against the plain
versions first (`chip_smoke.flash_close`: fp32 o and lse within 2e-5,
gradients within 2e-4; bf16 as that function states), its outputs'
bits are hashed (`digest`: two checkouts whose kernels agree to the bit
print the same), and its bounds
are this checkout's `chip_smoke.bound` (fp32: three TF32 passes at the
dense TF32 rate). `--cases` runs the named cases only; `--plain` also
times the plain versions (`flash_attention_fwd_plain`,
`flash_attention_bwd_plain`), twice each (`fwd_plain_ms`,
`bwd_plain_ms`).

`--root` runs the kernels of another checkout of this repo (for example
an older commit unpacked with `git archive`): its `hyperion_tpu_torch`
is imported and built, while the timing and the inputs are this
checkout's, so two versions compare in one call on one card when the
script runs old, new, new, old. Prints one JSON line a case, with
`root`.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
BF16, FP32 = torch.bfloat16, torch.float32
# name: (shape, dtype, causal, key padding: None, the last fraction of
# every row, or "ragged" (chip_smoke.ragged_pad))
CASES = {"bf16_causal_4096_d64": ((1, 4096, 8, 64), BF16, True, None),
         "bf16_long_train_d64": ((8, 4096, 4, 64), BF16, True, "ragged"),
         "bf16_causal_4096_d32": ((1, 4096, 8, 32), BF16, True, None),
         "bf16_llama_step_d128": ((1, 4096, 32, 128), BF16, True, 0.25),
         "fp32_causal": ((2, 1024, 8, 128), FP32, True, None),
         "fp32_full": ((2, 1024, 8, 128), FP32, False, None),
         "fp32_causal_4096_d64": ((1, 4096, 8, 64), FP32, True, None),
         "bf16_llama_masks_d256": ((1, 4096, 8, 256), BF16, True, 0.25),
         "bf16_causal_4096_d256": ((1, 4096, 8, 256), BF16, True, None),
         "bf16_lm_step_d256": ((2, 4096, 4, 256), BF16, True, "ragged"),
         "bf16_ragged_1000_d256": ((2, 1000, 8, 256), BF16, True, 0.1),
         "bf16_ragged_1000_d192": ((2, 1000, 8, 192), BF16, True, 0.1),
         "bf16_ragged_1000_d160": ((2, 1000, 8, 160), BF16, True, 0.1),
         "bf16_ragged_1000_d128": ((2, 1000, 8, 128), BF16, True, 0.1),
         "bf16_ragged_1000_d96": ((2, 1000, 8, 96), BF16, True, 0.1),
         "bf16_ragged_1000_d80": ((2, 1000, 8, 80), BF16, True, 0.1),
         "bf16_ragged_1000_d32": ((2, 1000, 8, 32), BF16, True, 0.1),
         "fp32_causal_d256": ((2, 1024, 8, 256), FP32, True, None),
         "fp32_full_d256": ((2, 1024, 8, 256), FP32, False, None),
         "fp32_lm_step_d512": ((2, 4096, 2, 512), FP32, True, "ragged"),
         "fp32_full_d512": ((2, 1024, 4, 512), FP32, False, None),
         "bf16_lm_step_d512": ((2, 4096, 2, 512), BF16, True, "ragged"),
         "fp32_lm_step_d2304": ((2, 2048, 1, 2304), FP32, True, "ragged")}


def load_smoke():
    """This checkout's chip_smoke.py (timing, inputs, bounds), under its
    own name, so that `--root`'s package is the one imported."""
    spec = importlib.util.spec_from_file_location("smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_case(cs, fa, name, shape, dtype, causal, padding,
                 plain=False) -> dict:
    B, T, H, D = shape
    seed = cs.SEED + 30
    q, k, v, do, pad = cs.flash_case(
        B, T, H, D, dtype, 0.0 if padding == "ragged" else padding, seed)
    if padding == "ragged":
        pad = cs.ragged_pad(B, T, seed)
    mask = dict(causal=causal, padding_mask=pad)
    o, lse = fa.flash_attention_fwd(q, k, v, **mask)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, **mask)
    checks = [cs.flash_close(o, ro, dtype, "o", D),
              cs.flash_close(lse, rlse, dtype, "lse", D)]
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **mask)
    checks += [cs.flash_close(a, r, dtype, w, D)
               for a, r, w in zip(grads, refs, ("dq", "dk", "dv"))]
    # the outputs' bits, to hold two checkouts' kernels to each other
    digest = {w: hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                                .numpy().tobytes()).hexdigest()[:16]
              for w, t in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads))}
    del ro, rlse, refs, grads
    n = q.numel() * q.element_size()
    stats = B * H * T * 4 + (0 if pad is None else pad.numel())  # lse, mask
    pairs = cs.flash_pairs(B, T, causal, pad)
    keep = torch.ones(T, T, dtype=torch.bool, device="cuda")
    if causal:
        keep = torch.tril(keep)
    mask4 = keep[None, None] if pad is None \
        else keep[None, None] & pad.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    side = cs.side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the graph's stream
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_o = sdpa(*(t.transpose(1, 2) for t in leaves), attn_mask=mask4)
        if causal:
            lib_c = sdpa(*(t.transpose(1, 2) for t in leaves),
                         is_causal=True)
    nf, nb = 4 * n + stats, 8 * n + stats
    timers = {
        ("fwd", "library"): lambda: cs.time_ms(
            lambda a, b, c: sdpa(a.transpose(1, 2), b.transpose(1, 2),
                                 c.transpose(1, 2), attn_mask=mask4),
            (q, k, v), nf),
        ("fwd", "kernel"): lambda: cs.time_ms(
            lambda a, b, c: fa._launch_fwd(a, b, c, pad, causal, True),
            (q, k, v), nf),
        ("bwd", "library"): lambda: cs.replay_ms(
            lambda lo, a, b, c, g: torch.autograd.grad(
                lo, (a, b, c), g, retain_graph=True),
            [(lib_o, *leaves, do.transpose(1, 2))]),
        ("bwd", "kernel"): lambda: cs.time_ms(
            lambda a, b, c, oo, ll, g: fa.flash_attention_bwd(
                a, b, c, oo, ll, g, **mask),
            (q, k, v, o, lse, do), nb),
    }
    rec = {"case": name, "shape": list(shape),
           "dtype": str(dtype).split(".")[-1], "causal": causal,
           "padded_keys": 0 if pad is None else int((pad == 0).sum()),
           "ok": all(ok for ok, _ in checks),
           "max_abs_err": {w: e for w, (_, e) in
                           zip(("o", "lse", "dq", "dk", "dv"), checks)},
           "digest": digest}
    turns = ("library", "kernel", "kernel", "library")
    if causal:
        timers[("fwd", "library_is_causal")] = lambda: cs.time_ms(
            lambda a, b, c: sdpa(a.transpose(1, 2), b.transpose(1, 2),
                                 c.transpose(1, 2), is_causal=True),
            (q, k, v), nf)
        timers[("bwd", "library_is_causal")] = lambda: cs.replay_ms(
            lambda lo, a, b, c, g: torch.autograd.grad(
                lo, (a, b, c), g, retain_graph=True),
            [(lib_c, *leaves, do.transpose(1, 2))])
        turns = ("library", "library_is_causal", "kernel", "kernel",
                 "library_is_causal", "library")
    for part in ("fwd", "bwd"):
        for who in turns:
            rec.setdefault(f"{part}_{who}_ms", []).append(
                timers[(part, who)]())
    # the backward's two launchers alone, twice each: dq (delta included)
    # and dk/dv (`dq_kernel_ms`, `dkv_kernel_ms`)
    dims, pad32, ins = fa._bwd_inputs(q, k, v, o, lse, do, pad)
    delta = fa._launch_dq(dims, pad32, *ins, causal)[1]
    nk = 6 * n + 2 * stats
    for part, fn, args in (
            ("dq", lambda *a: fa._launch_dq(dims, pad32, *a, causal), ins),
            ("dkv", lambda *a: fa._launch_dkv(dims, pad32, *a, causal),
             (*ins, delta))):
        rec[f"{part}_kernel_ms"] = [cs.time_ms(fn, args, nk) for _ in range(2)]
    if plain:
        for part, fn, args, nbytes in (
                ("fwd", lambda a, b, c: fa.flash_attention_fwd_plain(
                    a, b, c, **mask), (q, k, v), nf),
                ("bwd", lambda a, b, c, oo, ll, g:
                 fa.flash_attention_bwd_plain(a, b, c, oo, ll, g, **mask),
                 (q, k, v, o, lse, do), nb)):
            rec[f"{part}_plain_ms"] = [cs.time_ms(fn, args, nbytes)
                                       for _ in range(2)]
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = cs.bound(
        nf, 4.0 * D * H * pairs, dtype)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = cs.bound(
        nb, 10.0 * D * H * pairs, dtype)
    rec["attrs"] = {w: fa.kernel_attrs(w, D, dtype)
                    for w in ("fwd", "dq", "dkv")}
    del leaves, lib_o, ins, delta
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: all)")
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain versions")
    args = ap.parse_args()
    names = args.cases.split(",") if args.cases else list(CASES)
    unknown = sorted(set(names) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}; known: {sorted(CASES)}")
    root = args.root.resolve()
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
    for name in names:
        rec = profile_case(cs, fa, name, *CASES[name], plain=args.plain)
        cs.emit({**rec, "root": root.name})
        ok = ok and rec["ok"]
    print(json.dumps({"done": True, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
