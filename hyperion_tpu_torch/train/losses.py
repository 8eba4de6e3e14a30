"""Loss functions — `hyperion_tpu/train/losses.py:23-50`.

`next_token_loss` keeps the reference's shift-and-ignore-pad semantics:
position t's logits are scored against token t+1, in fp32, and only
real (non-pad) targets count toward the mean. `impl="pallas"` runs the
fused cross-entropy kernel (`ops.fused_ce`) over the `[B, T-1, V]` view
of the logits in place; `"xla"` runs its plain version. The CIFAR loss
waits for the CIFAR trainer (ROADMAP A9).
"""

from __future__ import annotations

import torch

from hyperion_tpu_torch.ops.fused_ce import (
    fused_softmax_xent,
    fused_softmax_xent_plain,
)


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None,
                    impl: str = "xla") -> torch.Tensor:
    """Causal-LM loss. logits [B, T, V]; input_ids and attention_mask
    [B, T] (mask 1 = real token)."""
    targets = input_ids[:, 1:]
    pred = logits[:, :-1].float()  # a view when the logits are fp32
    if impl == "pallas":
        per_tok = fused_softmax_xent(pred, targets)
    elif impl == "xla":
        per_tok = fused_softmax_xent_plain(pred, targets)
    else:
        raise ValueError(f"unknown loss impl {impl!r}")
    if attention_mask is None:
        return per_tok.mean()
    w = attention_mask[:, 1:].float()
    return (per_tok * w).sum() / w.sum().clamp_min(1.0)
