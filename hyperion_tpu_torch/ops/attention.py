"""Attention in plain PyTorch — the math the kernels are held to.

Counterparts: `NEG_INF`, `select_attention_impl`, `causal_mask` and
`dot_product_attention` are `hyperion_tpu/ops/attention.py:34-160`;
`grouped_cache_attention` is `_grouped_cache_attention` in
`hyperion_tpu/models/llama.py:202-223`.

`dot_product_attention` runs the reference's `"xla"` formulation as
plain ops, in the input dtype: q scaled in that dtype, the q·k product
in it, masked logits set to `NEG_INF`, softmax in fp32 and cast back,
then the p·v product. `impl="pallas"` is the flash kernel
(`ops/flash_attention.py`), and `impl="auto"` resolves per geometry
exactly as the reference does. `impl="ring"` and `"ulysses[:local]"`
are sequence parallelism over the active mesh's seq axis
(`ops/ring_attention.py`, `ops/ulysses.py`, whose local attention is
this function at `local`: "ulysses:pallas" runs the flash kernels);
with no active mesh they raise, as the reference does.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: keeps bf16 softmax NaN-free

# impl="auto" crossover of the reference (`ops/attention.py:42-43`):
# the flash kernel from 4096 tokens up, head_dim up to 128
PALLAS_MIN_SEQ = 4096
PALLAS_MAX_HEAD_DIM = 128


def select_attention_impl(seq_len: int, head_dim: int,
                          mode: str = "train") -> str:
    """Resolve impl="auto" to "pallas" or "xla" from call geometry;
    `mode="fwd"` (forward-only callers) doubles the threshold."""
    if head_dim > PALLAS_MAX_HEAD_DIM or seq_len % 128:
        return "xla"
    if mode == "fwd":
        return "pallas" if seq_len >= 2 * PALLAS_MIN_SEQ else "xla"
    return "pallas" if seq_len >= PALLAS_MIN_SEQ else "xla"


def causal_mask(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """[q_len, kv_len] lower-triangular bool mask (True = attend),
    aligned to the end of the kv sequence (queries shorter than kv, as
    in decode steps)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def _xla_attention(q, k, v, mask):
    """q [B, Tq, H, D]; k/v [B, Tkv, H, D]; mask broadcastable to
    [B, H, Tq, Tkv] (True = attend) or None."""
    # 1/sqrt(D) in fp32, then the input dtype, as the reference rounds it
    scale = (1.0 / torch.tensor(float(q.shape[-1])).sqrt()).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          padding_mask: torch.Tensor | None = None,
                          impl: str = "xla") -> torch.Tensor:
    """Attention over [batch, seq, heads, head_dim] tensors.

    padding_mask: [B, Tkv] with 1 = real token, 0 = pad."""
    if q.dim() != 4 or k.shape != v.shape or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"bad attention shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if impl in ("auto", "auto:fwd"):
        impl = select_attention_impl(
            q.shape[1], q.shape[-1],
            mode="fwd" if impl.endswith(":fwd") else "train")
    if impl == "pallas":
        # imported here: ops.flash_attention imports NEG_INF from this module
        from hyperion_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               padding_mask=padding_mask)
    # "ulysses:pallas": the sequence-parallel strategy and the local
    # attention it runs per rank (the ring has its own inner loop)
    strategy, _, local_impl = impl.partition(":")
    if strategy in ("ring", "ulysses"):
        from hyperion_tpu_torch.runtime.mesh import (
            AxisName,
            active_mesh,
            axis_sizes,
        )

        mesh = active_mesh()
        if mesh is None:
            raise ValueError(
                f"impl={impl!r} needs an active mesh — trainers register "
                "theirs via runtime.mesh.set_active_mesh")
        group = (mesh.get_group(AxisName.SEQ)
                 if axis_sizes(mesh)[AxisName.SEQ] > 1 else None)
        if strategy == "ring":
            from hyperion_tpu_torch.ops.ring_attention import ring_attention

            return ring_attention(q, k, v, group, causal=causal,
                                  padding_mask=padding_mask)
        from hyperion_tpu_torch.ops.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, group, causal=causal,
                                 padding_mask=padding_mask,
                                 impl=local_impl or "xla")
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")

    mask = None
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q.device)[None, None]
    if padding_mask is not None:
        pad = padding_mask[:, None, None, :].to(q.device, torch.bool)
        mask = pad if mask is None else mask & pad
    return _xla_attention(q, k, v, mask)


def grouped_cache_attention(q: torch.Tensor, ck: torch.Tensor,
                            cv: torch.Tensor, mask: torch.Tensor,
                            rep: int) -> torch.Tensor:
    """Attention over a KV cache without repeating K/V for GQA: the
    query's head axis folds into (kv_head, group) and the group rides
    the einsum. q [B, T, H, D]; ck/cv [B, S, Hkv, D]; mask [T, S]
    shared across the batch, or [B, T, S] per row. True = attend.
    Math in fp32, output in q's dtype."""
    B, T, H, D = q.shape
    Hkv = ck.shape[2]
    qf = q.float().reshape(B, T, Hkv, rep, D)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("btgrd,bsgd->bgrts", qf * scale, ck.float())
    mask = mask[None, None, None] if mask.dim() == 2 \
        else mask[:, None, None]  # → broadcastable over [B, g, r, T, S]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", weights, cv.float())
    return out.reshape(B, T, H, D).to(q.dtype)
