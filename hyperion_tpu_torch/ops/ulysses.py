"""Ulysses attention — `hyperion_tpu/ops/ulysses.py`: all-to-all
sequence parallelism over the mesh's `seq` axis.

Each of the n ranks of the seq group holds its slice of every row's
positions ([B, T/n, H, D]). One all-to-all (`parallel.collectives`,
with autograd) swaps the sharded axis from sequence to heads: every
rank then holds the whole sequence for H/n of the heads and runs
ordinary full-sequence attention on them through
`ops.attention.dot_product_attention` at the local impl ("xla", or
"pallas": the port's flash kernels, forward, dq and dk/dv, unmodified);
a second all-to-all swaps back. The padding mask is all-gathered,
since every rank sees every position. Parallelism is capped by the
head count: H % n raises, as in the reference. With one rank both
all-to-alls are the identity and no call reaches the process group.
"""

from __future__ import annotations

import torch

from hyperion_tpu_torch.ops.attention import dot_product_attention
from hyperion_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    group_size,
)


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, T/n, H, D] → [B, T, H/n, D]: heads split over the ranks,
    sequence slices concatenated in rank order."""
    B, Tl, H, D = x.shape
    parts = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = all_to_all(parts, group)              # [n src, B, Tl, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse: [B, T, H/n, D] → [B, T/n, H, D]."""
    B, T, Hl, D = x.shape
    parts = x.reshape(B, n, T // n, Hl, D).permute(1, 0, 2, 3, 4)
    got = all_to_all(parts, group)              # [n src, B, T/n, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hl, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, *, causal: bool = False,
                      padding_mask: torch.Tensor | None = None,
                      impl: str = "xla") -> torch.Tensor:
    """Attention over this rank's [B, T/n, H, D] slice of a sequence
    sharded over `group` (the seq axis's process group; None = one
    rank), by two all-to-alls around a full-sequence local attention at
    `impl`. padding_mask: this slice's [B, T/n]."""
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ulysses attention needs equal shapes, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}")
    n = group_size(group)
    H = q.shape[2]
    if H % n:
        raise ValueError(
            f"ulysses parallelism is capped by heads: H={H} not divisible "
            f"by seq={n} (use ring_attention past the head count)")
    pad = None
    if padding_mask is not None:
        pad = all_gather(padding_mask.to(q.device), group, dim=1)  # [B, T]
    out = dot_product_attention(
        _seq_to_heads(q, group, n), _seq_to_heads(k, group, n),
        _seq_to_heads(v, group, n), causal=causal, padding_mask=pad,
        impl=impl)
    return _heads_to_seq(out, group, n)
