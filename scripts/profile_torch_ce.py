"""The cross-entropy backward on one CUDA card as the train steps run it,
for this checkout or another one, so two versions compare in one call.

    python3 scripts/profile_torch_ce.py [--root DIR]

Cases: the fp32 [B, T, V] logits that the models hand the loss (their
`.float()` output) at the language_ddp train step [32, 128, 50257], the
seq-4096 step [8, 4096, 50257] (chip_smoke.py's train_long) and the
Llama-2-7B step [1, 4096, 32000], with [B, T-1] targets. For each:

  * `kernel_ms`: the backward kernel's launch on the loss path alone. A
    checkout with `_run_bwd_shifted` writes the gradient of the whole
    [B, T, V] logits; an older one writes the contiguous [B, T-1, V]
    gradient of the view (`_run_bwd`).
  * `loss_bwd_ms`: the checkout's whole backward of
    `next_token_loss(impl="pallas")` from the loss to the [B, T, V]
    logits, captured in a CUDA graph: in an older checkout that includes
    the slice backward's zero-fill and copy. `autograd_nodes` lists the
    nodes of that backward.
  * `bound_ms`: bytes over 3.35 TB/s (this checkout's
    `chip_smoke.bound`): the view read once and the whole gradient
    written once, which any version has to do.
  * `clone_ms`, `clone_bound_ms`: one `clone` of the [B, T, V] logits,
    a read and a write stream of about the kernel's bytes, and its own
    bound: what a plain stream reaches on this card.

Before timing, the gradient the loss path gives is held against the
plain version (`chip_smoke.ce_bwd_full_plain`, fp32 within 1e-6 of each
element's size, `chip_smoke.ce_bwd_fp32_ok`). `--root` imports and
builds another checkout's `hyperion_tpu_torch` (an older commit
unpacked with `git archive`, or a variant copy) while the inputs, the
checks and the timing are this checkout's: run old, new, new, old in one
call. Prints one JSON line a case, with `root`. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# name: (B, T, V) of the logits handed to the loss
CASES = {"train": (32, 128, 50257), "train_long": (8, 4096, 50257),
         "llama_train": (1, 4096, 32000)}


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


def profile_case(cs, ce, losses, name, B, T, V) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
    logits = 3 * torch.randn(B, T, V, generator=gen, device="cuda")
    ids = torch.randint(0, V, (B, T), generator=gen, device="cuda")
    view, tgt = logits[:, :-1], ids[:, 1:]
    rows = B * (T - 1)
    t32 = ce._checked_targets(view, tgt)
    _, lse = ce._run_fwd(view, t32)
    g = torch.full((B, T - 1), 1.0, device="cuda") / rows  # the mean's
    shifted = hasattr(ce, "_run_bwd_shifted")

    side = cs.side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the graph's stream
        leaf = logits.detach().requires_grad_()
        loss = losses.next_token_loss(leaf, ids, None, impl="pallas")
        (grad,) = torch.autograd.grad(loss, leaf, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    ref = cs.ce_bwd_full_plain(logits, tgt, lse, g)
    ok, worst = cs.ce_bwd_fp32_ok(grad, ref)
    del grad, ref
    nbytes = (rows * V + B * T * V) * 4 + 3 * 4 * rows
    rec = {"case": name, "shape": [B, T, V], "shifted_kernel": shifted,
           "ok": ok, "worst": worst,
           "autograd_nodes": graph_nodes(loss.grad_fn)}
    if shifted:
        rec["kernel_ms"] = cs.time_ms(ce._run_bwd_shifted,
                                      (logits, t32, lse, g), nbytes)
    else:
        rec["kernel_ms"] = cs.time_ms(
            lambda a, t, l, gg: ce._run_bwd(a[:, :-1], t, l, gg),
            (logits, t32, lse, g), nbytes)
    rec["loss_bwd_ms"] = cs.replay_ms(
        lambda lo, x: torch.autograd.grad(lo, x, retain_graph=True),
        [(loss, leaf)])
    rec["bound_ms"], rec["bound_by"] = cs.bound(nbytes, 4.0 * rows * V,
                                                torch.float32)
    rec["clone_ms"] = cs.time_ms(torch.clone, (logits,), 8 * logits.numel())
    rec["clone_bound_ms"] = cs.bound(8 * logits.numel(), 0,
                                     torch.float32)[0]
    del loss, leaf
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("profile_torch_ce: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # this checkout's, before --root is on the path

    sys.path.insert(0, str(root))
    from hyperion_tpu_torch.ops import fused_ce as ce
    from hyperion_tpu_torch.train import losses

    if not Path(ce.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ce.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit({"root": str(root), "device": torch.cuda.get_device_name(0)})
    ok = True
    for name, shape in CASES.items():
        rec = profile_case(cs, ce, losses, name, *shape)
        cs.emit({**rec, "root": root.name})
        ok = ok and rec["ok"]
        torch.cuda.empty_cache()
    print(json.dumps({"done": True, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
