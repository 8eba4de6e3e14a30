"""Paged attention: the hand-written CUDA kernel and its plain version.

Counterpart: `paged_attention` in
`hyperion_tpu/ops/pallas/paged_attention.py` (`_decode_kernel`, `:105`).
Both read a query window against the pooled K/V cache through each
row's block table: kv position `p` of row `b` lives at physical block
`block_tables[b, p // bs]`, offset `p % bs`, and is visible to the
window's token `t` iff `p <= base[b] + t`. Unmapped table entries are 0
— the serve engine's null block — and sit beyond every real row's
frontier, so whatever the null block holds never reaches an output.

`paged_attention_plain` is the reference's gather read
(`hyperion_tpu/models/llama.py:304-310`): copy each row's whole chain
into a contiguous `[B, MB*bs, Hkv, D]` view and run the masked grouped
attention. The kernel (`csrc/paged_attention.cu`) reads the pools in
place instead, with an online softmax, so the two agree to a tolerance
(2e-5 in fp32, the reference's own bound), not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from hyperion_tpu_torch.ops import build
from hyperion_tpu_torch.ops.attention import grouped_cache_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Z = 65535
_ROWS_PER_BLOCK = 4   # kWarps in the kernel
# q, k_pool, v_pool, block_tables, base, out; B, T, H, Hkv, D, bs, MB,
# dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _check_shapes(q, k_pool, v_pool, block_tables, base):
    B, T, H, D = q.shape
    Hkv = k_pool.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {Hkv}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    if k_pool.shape[3] != D:
        raise ValueError(f"head_dim: q {D}, pools {k_pool.shape[3]}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(base.shape) != (B,):
        raise ValueError(
            f"table/base batch mismatch: q {B}, tables "
            f"{tuple(block_tables.shape)}, base {tuple(base.shape)}")


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          base: torch.Tensor) -> torch.Tensor:
    """The gather read: q [B, T, H, D]; pools [NB, bs, Hkv, D];
    block_tables [B, MB] and base [B] integer. Returns [B, T, H, D] in
    q's dtype."""
    _check_shapes(q, k_pool, v_pool, block_tables, base)
    B, T, H, D = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    L = MB * bs
    bt = block_tables.long()
    vk = k_pool[bt].reshape(B, L, Hkv, D)
    vv = v_pool[bt].reshape(B, L, Hkv, D)
    kv_pos = torch.arange(L, device=q.device)[None, None, :]
    q_pos = base.long()[:, None, None] + \
        torch.arange(T, device=q.device)[None, :, None]
    mask = kv_pos <= q_pos  # [B, T, L]
    return grouped_cache_attention(q, vk, vv, mask, H // Hkv)


def _launch(q, k_pool, v_pool, block_tables, base):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pool, v_pool)):
        # the reference kernel has no VJP either: a launch here would
        # return an output with no gradient path, silently
        raise RuntimeError(
            "paged_attention has no gradient: call it under "
            "torch.no_grad() or on tensors that do not require grad")
    _check_shapes(q, k_pool, v_pool, block_tables, base)
    B, T, H, D = q.shape
    NB, bs, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel needs q and pools in one "
                        f"dtype: q {q.dtype}, pools {k_pool.dtype}")
    if D % 32 or not 0 < D <= 256:
        raise ValueError(f"paged_attention kernel takes head_dim a multiple "
                         f"of 32 up to 256, got {D}")
    if block_tables.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError("block_tables and base must be int32")
    rows = T * (H // Hkv)
    if -(-rows // _ROWS_PER_BLOCK) > _MAX_GRID_Z:
        raise ValueError(f"window of {rows} query rows exceeds the grid")
    ts = (q, k_pool, v_pool, block_tables, base)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_attention: all inputs on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention kernel needs contiguous inputs")
    fn = build.function("paged_attention", "hyperion_paged_attention",
                        _ARGTYPES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), base.data_ptr(), out.data_ptr(),
                    B, T, H, Hkv, D, bs, MB, _DTYPES[q.dtype], stream)
    build.check(status, "paged_attention launch")
    paged_attention.launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    """Attention straight against the paged KV pools.

    Args:
      q: [B, T, H, D] query window (T = 1 decode, k+1 verify, or a
        prefill chunk), rotary already applied.
      k_pool, v_pool: [num_blocks, block_size, Hkv, D], with the
        window's own K/V already scattered in.
      block_tables: [B, MB] int32 physical-block chain per row;
        unmapped tail entries are 0 (the null block).
      base: [B] int32 first logical position of the window per row.

    Returns [B, T, H, D] in q's dtype. CPU tensors take the plain
    gather read; CUDA tensors the kernel, which has no gradient (as the
    reference's has no VJP): a CUDA input that requires grad, with grad
    mode on, raises.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables, base)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, block_tables, base)


paged_attention.launches = 0  # kernel launches since the last reset
