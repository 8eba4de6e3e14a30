"""Ring attention — `hyperion_tpu/ops/ring_attention.py`: sequence
parallelism over the mesh's `seq` axis.

Each of the n ranks of the seq group holds its slice of every row's
positions ([B, T/n, H, D], slice i holding global positions
[i*T/n, (i+1)*T/n)). Step s of n: the K/V block (and its padding) that
started on rank (my - s) mod n is folded into this rank's queries'
fp32 online-softmax statistics (m, l, acc); then every block moves one
hop downstream (`parallel.collectives.shift_`, point to point over the
group). Causality uses global positions rebuilt from the ring index.
The arithmetic is the reference's, step for step: q scaled in fp32,
masked logits set to `NEG_INF`, the block's exponentials against the
running maximum, and acc / max(l, 1e-30) at the end, cast to q's dtype.
The products are plain `torch.matmul`: the reference's ring runs XLA
einsums, no Pallas kernel, so no hand kernel belongs here.

The backward is written by hand (`_Ring`): it recomputes each block's
probabilities from the saved log-sum-exp, and the K/V blocks go round
the ring again, now with their dK and dV accumulators, which arrive
back at their owner after the n-th hop — the transpose of the forward's
rotation, which JAX derives from `ppermute`. The last forward rotation
(whose result the reference discards) is skipped. With one rank the
ring is a single step and no call reaches the process group.
"""

from __future__ import annotations

import torch

from hyperion_tpu_torch.ops.attention import NEG_INF
from hyperion_tpu_torch.parallel.collectives import (
    group_rank,
    group_size,
    shift_,
)


def _keep(B, Tl, my, src, causal, pad_blk, device):
    """[B|1, 1, Tl, Tl] bool (True = attend) for the block of rank
    `src`, or None when nothing is masked."""
    keep = None
    if causal:
        q_pos = my * Tl + torch.arange(Tl, device=device)[:, None]
        kv_pos = src * Tl + torch.arange(Tl, device=device)[None, :]
        keep = (kv_pos <= q_pos)[None, None]
    if pad_blk is not None:
        p = (pad_blk > 0)[:, None, None, :]
        keep = p if keep is None else keep & p
    return keep


def _logits(qf, k_blk, keep):
    kf = k_blk.float().transpose(1, 2)  # [B, H, Tl, D]
    logits = qf @ kf.transpose(-1, -2)
    if keep is not None:
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    return logits, kf


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad, group, causal, scale):
        n, my = group_size(group), group_rank(group)
        B, Tl, H, D = q.shape
        qf = (q.float() * scale).transpose(1, 2)  # [B, H, Tl, D]
        m = torch.full((B, H, Tl), NEG_INF, device=q.device)
        l = torch.zeros((B, H, Tl), device=q.device)
        acc = torch.zeros((B, H, Tl, D), device=q.device)
        blk = [k, v] + ([pad] if pad is not None else [])
        for s in range(n):
            src = (my - s) % n
            keep = _keep(B, Tl, my, src, causal,
                         blk[2] if pad is not None else None, q.device)
            logits, _ = _logits(qf, blk[0], keep)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ blk[1].float().transpose(1, 2)
            m = m_new
            if s < n - 1:
                blk = shift_(blk, group)
        out = acc / l.clamp_min(1e-30)[..., None]
        ctx.save_for_backward(q, k, v, pad, out, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, my = group_size(group), group_rank(group)
        B, Tl, H, D = q.shape
        qf = (q.float() * scale).transpose(1, 2)
        do = dout.float().transpose(1, 2)          # [B, H, Tl, D]
        delta = (do * out).sum(-1, keepdim=True)   # [B, H, Tl, 1]
        dq = torch.zeros_like(qf)
        blk = [k, v] + ([pad] if pad is not None else [])
        dkv = [torch.zeros_like(qf), torch.zeros_like(qf)]  # ride with blk
        for s in range(n):
            src = (my - s) % n
            keep = _keep(B, Tl, my, src, causal,
                         blk[2] if pad is not None else None, q.device)
            logits, kf = _logits(qf, blk[0], keep)
            p = torch.exp(logits - lse[..., None])
            dp = do @ blk[1].float().transpose(1, 2).transpose(-1, -2)
            ds = p * (dp - delta)
            if keep is not None:
                ds = torch.where(keep, ds, torch.zeros_like(ds))
            dq = dq + ds @ kf
            dkv[0] = dkv[0] + ds.transpose(-1, -2) @ qf
            dkv[1] = dkv[1] + p.transpose(-1, -2) @ do
            # blocks move on with their accumulators; after the n-th hop
            # each dK/dV is back on the rank that owns its block
            if s < n - 1:
                moved = shift_(blk + dkv, group)
                blk, dkv = moved[:len(blk)], moved[len(blk):]
            else:
                dkv = shift_(dkv, group)
        dq = (dq * scale).transpose(1, 2).to(q.dtype)
        dk = dkv[0].transpose(1, 2).to(k.dtype)
        dv = dkv[1].transpose(1, 2).to(v.dtype)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = False,
                   padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over this rank's [B, T/n, H, D] slice of a sequence
    sharded over `group` (the seq axis's process group; None = one
    rank). padding_mask: this slice's [B, T/n], 1 = real token; it rides
    the ring with its K/V block."""
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring attention needs equal shapes, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}")
    scale = 1.0 / (q.shape[-1] ** 0.5)
    pad = None if padding_mask is None else padding_mask.to(q.device)
    return _Ring.apply(q, k, v, pad, group, causal, scale)
