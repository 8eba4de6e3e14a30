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
"""

from __future__ import annotations

import torch

from hyperion_tpu_torch.ops.fused_ce import (
    fused_softmax_xent_plain,
    fused_softmax_xent_shifted,
)


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None,
                    impl: str = "xla") -> torch.Tensor:
    """Causal-LM loss. logits [B, T, V]; input_ids and attention_mask
    [B, T] (mask 1 = real token)."""
    targets = input_ids[:, 1:]
    if impl == "pallas":  # .float(): no copy when the logits are fp32
        per_tok = fused_softmax_xent_shifted(logits.float(), targets)
    elif impl == "xla":
        per_tok = fused_softmax_xent_plain(logits[:, :-1].float(), targets)
    else:
        raise ValueError(f"unknown loss impl {impl!r}")
    if attention_mask is None:
        return per_tok.mean()
    w = attention_mask[:, 1:].float()
    return (per_tok * w).sum() / w.sum().clamp_min(1.0)
