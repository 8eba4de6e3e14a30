"""RMSNorm on one CUDA card, forward and backward, for this checkout or
another one, so two versions compare in one call.

    python3 scripts/profile_torch_norm.py [--root DIR]

Cases: the Llama-2-7B LoRA step's rows ([4096, 4096], bf16 and fp32)
and the serve decode tick's ([4, 1, 4096] bf16: 4 slots, one token).
For each, with the inputs cold (`chip_smoke.time_ms`):

  * `fwd_ms`: `fused_rmsnorm`'s launch, beside `fwd_library_ms`
    (`F.rms_norm`, weight in x's dtype) and `fwd_bound_ms`; `fwd_path`,
    where the checkout can say, names the kernel that ran. `clone_ms`:
    one `clone` of x, a plain read and write stream of the forward's
    bytes: what such a stream reaches on this card at this size.
  * `bwd_ms`, `bwd_dw_ms`: the checkout's whole RMSNorm backward, from
    the output to x (the LoRA step: the weight frozen) and to x and the
    weight, captured in a CUDA graph with the forward outside it
    (`chip_smoke.bwd_replay_ms`): in an older checkout the eager VJP of
    the plain version, in a newer one its backward kernel.
    `bwd_library_ms`, `bwd_dw_library_ms`: `F.rms_norm`'s own backward
    the same way. `bwd_bound_ms`: x and g read and dx written once
    (plus the weight, and for dw its gradient).
  * `bwd_kernel_ms`, `bwd_dw_kernel_ms`: the backward kernel's launch
    alone, where the checkout has one.
  * `bwd_nodes`, `bwd_launches`: the autograd nodes of the backward and
    the device operations one backward runs (kernels, memsets and
    copies, from torch.profiler), by name.
  * `empty_ms` (decode tick, where the checkout has the entry point):
    an empty kernel of the forward's grid launched the same way, the
    floor a launch of this size cannot go below.

Before timing, the forward is held against the plain version (one bf16
ulp, 2e-5 in fp32) and the backward's dx and dw against autograd of the
plain version (`chip_smoke.ln_ulp_ok`, `rms_dw_ok`). `--root` imports
and builds another checkout's `hyperion_tpu_torch` (an older commit
unpacked with `git archive`, or a variant copy) while the inputs, the
checks and the timing are this checkout's: run old, new, new, old in
one call. Prints one JSON line a case, with `root`. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# name: (shape, dtype)
CASES = {"llama_step_bf16": ((4096, 4096), torch.bfloat16),
         "llama_step_fp32": ((4096, 4096), torch.float32),
         "decode_tick_bf16": ((4, 1, 4096), torch.bfloat16)}


def graph_nodes(fn) -> list[str]:
    """The names of the autograd nodes reachable from `fn`."""
    seen, todo, names = set(), [fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(node.name())
        todo.extend(f for f, _ in node.next_functions)
    return sorted(names)


def device_ops(fn) -> dict[str, int]:
    """{name: count} of the device operations one call of `fn` runs."""
    fn()  # warm: allocator and any first-use build outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def cold_sets(tensors: tuple, nbytes: float, cs) -> list[tuple]:
    """`tensors` and enough clones of them that together they exceed
    twice the L2 cache."""
    copies = max(1, math.ceil(2 * cs.L2_BYTES / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies - 1)]


def profile_case(cs, fn, name, shape, dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 50)
    x, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    d = shape[-1]
    rows = x.numel() // d
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    esize = x.element_size()
    rec = {"case": name, "shape": list(shape),
           "dtype": str(dtype).split(".")[-1]}

    out = fn.fused_rmsnorm(x, w)
    fwd_ok, fwd_worst = cs.rms_ulp_ok(out, fn.fused_rmsnorm_plain(x, w))
    checks = {"fwd": fwd_ok}
    rec["fwd_worst"] = fwd_worst
    for need_w, tag in ((False, ""), (True, "_dw")):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_(need_w)
        fn.fused_rmsnorm(xs, ws).backward(g)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_(need_w)
        fn.fused_rmsnorm_plain(xr, wr).backward(g)
        ok, rec[f"bwd{tag}_dx_worst"] = cs.ln_ulp_ok(xs.grad, xr.grad)
        checks[f"bwd{tag}_dx"] = ok
        if need_w:
            ok, rec["bwd_dw_dw_worst"] = cs.rms_dw_ok(ws.grad, wr.grad, rows)
            checks["bwd_dw_dw"] = ok
    rec["ok"] = all(checks.values())
    rec["checks"] = checks
    if hasattr(fn, "rmsnorm_path"):
        rec["fwd_path"] = fn.rmsnorm_path(x, w)

    fwd_bytes = 2 * x.numel() * esize + 4 * d
    rec["fwd_ms"] = cs.time_ms(fn.fused_rmsnorm, (x, w), fwd_bytes)
    rec["fwd_library_ms"] = cs.time_ms(
        lambda a, b: torch.nn.functional.rms_norm(a, (d,), b, 1e-5),
        (x, w.to(dtype)), fwd_bytes)
    rec["fwd_bound_ms"] = cs.bound(fwd_bytes, 4.0 * x.numel(), dtype)[0]
    rec["clone_ms"] = cs.time_ms(torch.clone, (x,), fwd_bytes)
    if name.startswith("decode"):
        try:
            from hyperion_tpu_torch.ops import build
            empty = build.function("fused_norm", "hyperion_norm_empty",
                                   [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p])
        except AttributeError:  # a checkout without the entry point
            empty = None
        if empty is not None:
            threads = 256  # the block kernel's at d 4096 in bf16
            rec["empty_ms"] = cs.time_ms(
                lambda a: empty(rows, threads,
                                torch.cuda.current_stream().cuda_stream),
                (x,), fwd_bytes)

    bwd_bytes = 3 * x.numel() * esize + 4 * d
    sets = cold_sets((x, g), bwd_bytes, cs)
    for need_w, tag in ((False, ""), (True, "_dw")):
        wt = w.clone().requires_grad_(need_w)
        wl = w.to(dtype, copy=True).requires_grad_(need_w)
        rec[f"bwd{tag}_ms"] = cs.bwd_replay_ms(
            fn.fused_rmsnorm, [(a, wt, b) for a, b in sets])
        rec[f"bwd{tag}_library_ms"] = cs.bwd_replay_ms(
            lambda a, b: torch.nn.functional.rms_norm(a, (d,), b, 1e-5),
            [(a, wl, b) for a, b in sets])
        rec[f"bwd{tag}_bound_ms"] = cs.bound(
            bwd_bytes + (8 * d if need_w else 0), 10.0 * x.numel(),
            dtype)[0]
        if hasattr(fn, "fused_rmsnorm_bwd"):
            rec[f"bwd{tag}_kernel_ms"] = cs.time_ms(
                lambda a, b, c: fn.fused_rmsnorm_bwd(a, b, c,
                                                     need_dw=need_w),
                (x, w, g), bwd_bytes)
        leaf = x.detach().requires_grad_()
        y = fn.fused_rmsnorm(leaf, wt)
        rec[f"bwd{tag}_nodes"] = graph_nodes(y.grad_fn)
        wrt = (leaf, wt) if need_w else (leaf,)
        rec[f"bwd{tag}_launches"] = device_ops(
            lambda: torch.autograd.grad(y, wrt, g, retain_graph=True))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("profile_torch_norm: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # this checkout's, before --root is on the path

    sys.path.insert(0, str(root))
    from hyperion_tpu_torch.ops import fused_norm as fn

    if not Path(fn.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fn.__file__}, not from {root}")
    cs.emit({"root": str(root), "device": torch.cuda.get_device_name(0)})
    ok = True
    for name, (shape, dtype) in CASES.items():
        rec = profile_case(cs, fn, name, shape, dtype)
        cs.emit({**rec, "root": root.name})
        ok = ok and rec["ok"]
        torch.cuda.empty_cache()
    print(json.dumps({"done": True, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
