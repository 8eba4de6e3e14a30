"""Activation rematerialization — `hyperion_tpu/precision/remat.py` with
`torch.utils.checkpoint` in place of `jax.checkpoint`.

A policy names which intermediates a wrapped function keeps for its
backward; the rest are recomputed from its inputs when the backward
reaches it:

  * "none": keep everything (the function is returned unwrapped);
  * "full": keep nothing — `checkpoint(fn, use_reentrant=False)`, the
    reference's `nothing_saveable`;
  * "dots": keep the outputs of every matrix product, recompute the
    rest — `checkpoint_dots`, as a selective-checkpoint policy over the
    aten matmul ops;
  * "dots_no_batch": keep only products without a batch dimension (the
    projections, not attention's batched products) —
    `checkpoint_dots_with_no_batch_dims`.

The non-reentrant form carries gradients to parameters used inside the
function even when its inputs need none (a frozen embedding feeding a
LoRA stack), and lets the recompute stop once the saved tensors it
needs are rebuilt.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

_aten = torch.ops.aten
# products with no batch dimension: a projection's [N, K] x [K, M]
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)

REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")


def normalize_remat(value) -> str:
    """Model configs accept bool (legacy) or policy-name remat values;
    normalize to a REMAT_POLICIES name."""
    if value is False or value is None:
        return "none"
    if value is True:
        return "full"
    if value not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {value!r}; have {sorted(REMAT_POLICIES)}")
    return value


def _save_dots(ops):
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


_CONTEXTS = {
    "dots": _save_dots(_NO_BATCH_DOTS + _BATCH_DOTS),
    "dots_no_batch": _save_dots(_NO_BATCH_DOTS),
}


def apply_remat(fn, policy: str = "none"):
    """`fn` wrapped in activation checkpointing under the named policy;
    "none" returns `fn` untouched so call sites need not branch."""
    if policy == "none":
        return fn
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; have "
                         f"{sorted(REMAT_POLICIES)}")
    kw = {} if policy == "full" else {"context_fn": _CONTEXTS[policy]}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw,
                               **kwargs)

    return wrapped
