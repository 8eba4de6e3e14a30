"""Loss functions — `hyperion_tpu/train/losses.py:23-50`.

`next_token_loss` keeps the reference's shift-and-ignore-pad semantics:
position t's logits are scored against token t+1, in fp32, and only
real (non-pad) targets count toward the mean. `impl="pallas"` runs the
fused cross-entropy kernels (`ops.fused_ce.fused_softmax_xent_shifted`)
on the whole `[B, T, V]` logits: the forward reads rows t < T-1 in place
by strides, and the backward writes the gradient of the whole tensor,
so no slice backward zero-fills and copies it. `"xla"` runs the plain
version on the `[B, T-1, V]` view. The CIFAR loss waits for the CIFAR
trainer (ROADMAP A9).

Under data parallelism (`sync`, a `train.step.BatchSync`) the mean is
over the global batch, as the JAX loss over a sharded batch is: each
rank's sum of real-token losses is divided by the count over every
rank (all-reduced), not by its own, so ranks that hold different
numbers of pad tokens give the global mean and not a mean of means.
"""

from __future__ import annotations

import torch

from hyperion_tpu_torch.ops.fused_ce import (
    fused_softmax_xent_plain,
    fused_softmax_xent_shifted,
)


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None,
                    impl: str = "xla", sync=None) -> torch.Tensor:
    """Causal-LM loss. logits [B, T, V]; input_ids and attention_mask
    [B, T] (mask 1 = real token). With `sync`, this rank's share of the
    global mean (`BatchSync.global_mean`)."""
    targets = input_ids[:, 1:]
    if impl == "pallas":  # .float(): no copy when the logits are fp32
        per_tok = fused_softmax_xent_shifted(logits.float(), targets)
    elif impl == "xla":
        per_tok = fused_softmax_xent_plain(logits[:, :-1].float(), targets)
    else:
        raise ValueError(f"unknown loss impl {impl!r}")
    if sync is not None and sync.active:
        if attention_mask is None:
            return sync.global_mean(per_tok.sum(), per_tok.new_tensor(
                float(per_tok.numel())))
        w = attention_mask[:, 1:].float()
        return sync.global_mean((per_tok * w).sum(), w.sum())
    if attention_mask is None:
        return per_tok.mean()
    w = attention_mask[:, 1:].float()
    return (per_tok * w).sum() / w.sum().clamp_min(1.0)
