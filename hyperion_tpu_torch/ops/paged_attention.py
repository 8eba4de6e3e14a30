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

`plan` decides how a launch cuts the work: query rows a block (16 or
64) and splits of the chain (flash-decoding), from the shapes alone.
It reads no tensor, so a launch never waits on the card and a CUDA
graph captures it whole; with more than one split the kernel writes
fp32 partials into a workspace allocated here, and a second kernel of
the same launch merges them.

Any head_dim runs, as the reference's kernel takes any: D up to 256 on
the instantiation at the next multiple of 16 (`kernel_head_dim`), q and
the pools read at their own width with the columns past D as zeros
(rows whose bytes are no multiple of 16 in narrower units), and past
256 on the wide kernel, whose blocks each own one chunk of at most 192
output columns (`Plan.chunks`) and sum q . k^T over D in 64-column
steps. No pool is copied to a padded width.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from hyperion_tpu_torch.ops import build
from hyperion_tpu_torch.ops.attention import grouped_cache_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = range(16, 257, 16)  # the instantiations D <= 256 runs on
WIDE_CHUNK = 192    # output columns a block of the wide kernel, at most
KV_TILE = 32        # kv positions a tile (kN in the kernel)
SMS = 132           # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 2048    # positions a split walks at most: its pool row
                    # indices sit in shared memory (8 KB)
_GRID_X = 2 ** 31 - 1
_GRID_YZ = 65535
# q, k_pool, v_pool, block_tables, base, out, workspace; B, T, H, Hkv, D,
# bs, MB; warps, row_tiles, n_splits, split_len, chunks; dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
# which (0 split kernel, 1 combine), D, dtype, warps, split_len, int out[4]
_ATTRS_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]


def kernel_head_dim(D: int) -> int:
    """The instantiation that runs head_dim D: the next multiple of 16 up
    to 256; past 256 the wide kernel, which takes the tensors at D."""
    if D <= 0:
        raise ValueError(f"paged_attention takes head_dim >= 1, got {D}")
    return -(-D // 16) * 16 if D <= HEAD_DIMS[-1] else D


def wide_chunks(D: int) -> int:
    """Output-column chunks of a row D wide: 1 up to 256, else one block
    for each WIDE_CHUNK columns or part of them (the kernel's
    `wide_chunks`)."""
    return 1 if D <= HEAD_DIMS[-1] else -(-D // WIDE_CHUNK)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch cuts its work: blocks of `warps` warps (16 query
    rows each), `row_tiles` of them over the window's T * H / Hkv rows,
    times `n_splits` splits of `split_len` kv positions over the chain
    [0, MB * bs), times `chunks` chunks of the output columns (past D
    256). Grid (row_tiles * n_splits * chunks, Hkv, B)."""

    warps: int
    row_tiles: int
    n_splits: int
    split_len: int
    chunks: int = 1

    def grid(self, B: int, Hkv: int) -> tuple[int, int, int]:
        return (self.row_tiles * self.n_splits * self.chunks, Hkv, B)


@functools.lru_cache(maxsize=256)  # a serve run meets a handful of shapes
def plan(B: int, T: int, H: int, Hkv: int, D: int, bs: int,
         MB: int) -> Plan:
    """The launch plan from shapes alone (never from `base` or the
    tables, which live on the card). A window of at most 16 query rows
    (decode, verify) takes one-warp blocks and enough splits for ~8
    blocks an SM, since its bytes, not its products, bound it; wider
    windows (prefill) take 64-row blocks and split only when their row
    tiles do not fill the card once; past D 256 each block owns a chunk
    of the output columns. Raises ValueError on what the kernel cannot
    take."""
    chunks = wide_chunks(kernel_head_dim(D))
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {Hkv}")
    if MB * bs <= 0:
        raise ValueError(f"paged_attention needs a table of at least one "
                         f"position, got {MB} blocks of {bs}")
    rows = T * (H // Hkv)
    warps = 1 if rows <= 16 else 4
    row_tiles = -(-rows // (16 * warps))
    n_tiles = -(-(MB * bs) // KV_TILE)
    blocks = max(1, B * Hkv * row_tiles * chunks)
    want = -(-(8 * SMS if warps == 1 else SMS) // blocks)
    per_split = min(-(-n_tiles // want), MAX_SPLIT // KV_TILE)
    n_splits = -(-n_tiles // per_split)
    p = Plan(warps, row_tiles, n_splits, per_split * KV_TILE, chunks)
    x, y, z = p.grid(B, Hkv)
    if x > _GRID_X or y > _GRID_YZ or z > _GRID_YZ:
        raise ValueError(f"paged_attention: grid {(x, y, z)} exceeds CUDA's "
                         "limits")
    return p


def plan_for(q: torch.Tensor, k_pool: torch.Tensor,
             block_tables: torch.Tensor) -> Plan:
    """`plan` at these tensors' shapes: reads `.shape` only."""
    B, T, H, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    return plan(B, T, H, Hkv, D, bs, block_tables.shape[1])


def cost(B: int, T: int, H: int, Hkv: int, D: int, bs: int, MB: int,
         bases, itemsize: int) -> tuple[float, float]:
    """(bytes, FLOPs) one call needs at these shapes and per-row window
    starts `bases` [B], counting what the data needs, not the table's
    worst case:

      * bytes: q read and the output written once each (B*T*H*D
        elements apiece), the K and V of every position a row's frontier
        covers (min(base + T, MB*bs) per row, Hkv*D elements each) read
        once, and the int32 block tables [B, MB] and bases [B];
      * FLOPs: 4*D per visible (query head, position) pair — 2*D for
        q.k and 2*D for p.v — where the query at window offset t of row
        b sees min(base_b + t + 1, MB*bs) positions."""
    L = MB * bs
    bases = np.asarray(bases, np.int64)
    visible = np.minimum(bases + T, L)
    nbytes = 2 * B * T * H * D * itemsize \
        + 2 * int(visible.sum()) * Hkv * D * itemsize + B * MB * 4 + B * 4
    pairs = int(np.minimum(bases[:, None] + np.arange(T)[None, :] + 1,
                           L).sum())
    return float(nbytes), 4.0 * D * H * pairs


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


def _launch(q, k_pool, v_pool, block_tables, base, p: Plan | None = None):
    """The kernel launch; `p` replaces `plan`'s choice (for comparing
    plans on the card, scripts/profile_torch_paged.py)."""
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
    p = plan(B, T, H, Hkv, D, bs, MB) if p is None else p
    if block_tables.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError("block_tables and base must be int32")
    ts = (q, k_pool, v_pool, block_tables, base)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_attention: all inputs on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in ts[:3]):
        raise ValueError("paged_attention kernel needs q and the pools "
                         "16-byte aligned")
    fn = build.function("paged_attention", "hyperion_paged_attention",
                        _ARGTYPES)
    out = torch.empty_like(q)
    ws = None
    if p.n_splits > 1:  # fp32 partials: acc [.., D] and (m, l) per split
        ws = torch.empty(B * T * H * p.n_splits * (D + 2),
                         dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), base.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(),
                    B, T, H, Hkv, D, bs, MB, p.warps, p.row_tiles,
                    p.n_splits, p.split_len, p.chunks, _DTYPES[q.dtype],
                    stream)
    build.check(status, "paged_attention launch")
    paged_attention.launches += 1
    return out


def kernel_attrs(D: int, dtype: torch.dtype, p: Plan,
                 which: str = "split") -> dict:
    """What the compiler gave the kernel `which` ("split": the attention
    kernel that runs head_dim D, at plan `p`; "combine": the merge of the
    splits) at this dtype: registers and local-memory (spill) bytes a
    thread, shared memory and threads a block. Needs the card."""
    fn = build.function("paged_attention", "hyperion_paged_attrs",
                        _ATTRS_ARGTYPES)
    out = (ctypes.c_int * 4)()
    build.check(fn({"split": 0, "combine": 1}[which], D, _DTYPES[dtype],
                   p.warps, p.split_len, out),
                "paged_attention kernel attributes")
    return {"registers": out[0], "spill_bytes": out[1],
            "smem_bytes": out[2], "threads": out[3]}


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
