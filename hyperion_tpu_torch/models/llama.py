"""Llama-2 in PyTorch — `hyperion_tpu/models/llama.py`.

Same architecture and names as the JAX module: RMSNorm (eps 1e-5),
split-half rotary embeddings from an fp32 table, GQA attention, SwiGLU
MLP, untied embeddings, fp32 logits. Weights live in the compute dtype
except the norm weights, which stay fp32 as the JAX params do.

`norm_impl` picks the RMSNorm as the reference does: "xla" (the
default) is the JAX module's own formula — variance in fp32, the
normalised activations and then the weight multiplied in the compute
dtype, two roundings in bf16 — and "pallas" is `ops.fused_rmsnorm`
(fp32 throughout, one cast: the CUDA kernel on the card, its plain
version on the CPU).

The cache-free call (`cache=None`, `:362-368` and `:445-482` there) is
the training forward: attention over the whole window with the causal
and `[B, T]` padding masks through `ops.dot_product_attention` at
`attention_impl` ("pallas" / "auto" reach the flash kernel), K/V heads
repeated for GQA, each block rematerialized per `remat`
(`precision.remat`), and gradients carried. With `lora_rank > 0` the
projections named in `lora_targets` are `models.lora.LoraDense`: the
base weights stay frozen and only the adapters train (LoRA and int8
are mutually exclusive).

`quant="int8"` is weight-only int8 inference (`precision/quant.py`):
every projection the reference's `make_dense` routes — q/k/v/o,
gate/up/down and `lm_head` — is a `QuantDense` (an int8 weight and a
per-output fp32 scale, activations quantized per row at each call, the
int8 product of `ops/int8_matmul.py`); the embedding and the norms stay
float. `quantize_llama` converts a float model's weights.

Two cache call forms, as in the reference, both without gradients:

  * **paged** (`block_tables` given, `:272-318` there): `cache` is the
    pooled `init_paged_cache` layout; the window's K/V scatter through
    each row's block table (positions the table does not cover go to
    the null block 0), then `ops.paged_attention` reads the pools in
    place — the CUDA kernel on the card, the gather read on the CPU.
  * **contiguous** (`:320-360` there): `cache` is the `init_cache`
    slab, `cache_index` a scalar or a [B] vector of per-row depths;
    attention is the plain masked grouped attention. `infer.generate`
    uses this form.

Both forms update the cache tensors IN PLACE (`index_put_`), where the
JAX engine donates its buffers; the returned cache is the same list.

Weights cross over from the JAX package (`params_from_jax`,
`params_to_jax`) and from a local HF checkpoint
(`params_from_hf_state_dict`, `load_hf_checkpoint`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.models.lora import LoraDense
from hyperion_tpu_torch.ops.attention import (
    dot_product_attention,
    grouped_cache_attention,
)
from hyperion_tpu_torch.ops.fused_norm import fused_rmsnorm
from hyperion_tpu_torch.ops.paged_attention import paged_attention
from hyperion_tpu_torch.precision.quant import check_quant, make_dense
from hyperion_tpu_torch.precision.remat import apply_remat, normalize_remat


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32          # 7B has no GQA; kept for 70B-shaped configs
    ff_dim: int = 11008
    max_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attention_impl: str = "xla"   # the cache-free forward's attention
    norm_impl: str = "xla"        # xla | pallas (fused_rmsnorm kernel)
    quant: str = "none"           # none | int8 (weight-only, precision/quant.py)
    # rank > 0 routes the targeted projections through LoraDense's
    # activation side-path
    lora_rank: int = 0
    lora_scale: float = 2.0       # alpha / r at the peft defaults (32/16)
    lora_targets: tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    # the cache-free forward's remat: False/"none", True/"full", "dots",
    # "dots_no_batch" (precision.remat)
    remat: bool | str = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.lora_rank > 0 and self.quant != "none":
            raise ValueError("LoRA training and int8 inference quant are "
                             "mutually exclusive (train float, then merge "
                             "+ quantize)")
        check_quant(self.quant)
        if self.norm_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown norm_impl {self.norm_impl!r}")
        normalize_remat(self.remat)

    @property
    def remat_policy(self) -> str:
        return normalize_remat(self.remat)

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def llama2_7b_config(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama2_70b_config(**kw) -> LlamaConfig:
    """70B-shaped: 64 query heads sharing 8 KV heads."""
    base = dict(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                ff_dim=28672)
    base.update(kw)
    return LlamaConfig(**base)


def llama_tiny_config(**kw) -> LlamaConfig:
    """Test-sized config with the real op mix."""
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=4, ff_dim=128, max_len=64, remat=False,
                dtype="float32")
    base.update(kw)
    return LlamaConfig(**base)


class _Dense(nn.Module):
    """Bias-free projection, weight [out, in] in the compute dtype."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return F.linear(x, self.weight)


def _dense(c: LlamaConfig, name: str, d_in: int, d_out: int, device):
    """A projection named `name`: `LoraDense` where the config trains
    an adapter on it (`_dense_ctor` of the reference), else `_Dense`,
    or `QuantDense` under `quant="int8"` (`precision.quant.make_dense`)."""
    if c.lora_rank > 0 and name in c.lora_targets:
        return LoraDense(d_in, d_out, c.lora_rank, c.lora_scale,
                         c.compute_dtype, device)
    return make_dense(c, _Dense, d_in, d_out, device)


def rms_norm_xla(x: torch.Tensor, weight: torch.Tensor, eps: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """The JAX module's RMSNorm (`:167-170` there): variance in fp32,
    `x * rsqrt(var + eps)` rounded to x's dtype, then times the weight
    cast to `dtype`."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * weight.to(dtype)


class RMSNorm(nn.Module):
    """`impl="xla"`: `rms_norm_xla`; `impl="pallas"`: the fused kernel's
    math (`ops.fused_norm`), on the card the CUDA kernel, which takes
    the weight in fp32 whatever its param dtype."""

    def __init__(self, d: int, eps: float, impl: str, dtype: torch.dtype,
                 device):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(d, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        if self.impl == "pallas":
            return fused_rmsnorm(x, self.weight.float(), eps=self.eps)
        return rms_norm_xla(x, self.weight, self.eps, self.dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float,
                     device=None) -> torch.Tensor:
    """[max_len, head_dim/2, 2] (cos, sin) table, fp32 — computed in
    numpy exactly as the reference does."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                          / head_dim)
    t = np.arange(max_len, dtype=np.float32)
    ang = np.outer(t, inv)
    table = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def apply_rope(x: torch.Tensor, table: torch.Tensor, offset=0) -> torch.Tensor:
    """Rotate [B, T, H, D] by the table rows offset..offset+T-1, where
    `offset` is an int or a [B] tensor of per-row offsets. Rows past
    the table (only bucket padding reaches them) reuse its last row;
    real positions always fit, since every cache is bounded by
    max_len."""
    B, T = x.shape[0], x.shape[1]
    steps = torch.arange(T, device=x.device)
    if isinstance(offset, torch.Tensor) and offset.dim() >= 1:
        pos = offset.to(x.device).long()[:, None] + steps[None, :]  # [B, T]
    else:
        pos = (int(offset) + steps)[None, :]                        # [1, T]
    rows = table[pos.clamp(max=table.shape[0] - 1)]  # [B|1, T, D/2, 2]
    cos = rows[..., 0][:, :, None, :]
    sin = rows[..., 1][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        self.c = c
        Dh = c.head_dim
        self.q_proj = _dense(c, "q_proj", c.d_model, c.n_heads * Dh, device)
        self.k_proj = _dense(c, "k_proj", c.d_model, c.n_kv_heads * Dh,
                             device)
        self.v_proj = _dense(c, "v_proj", c.d_model, c.n_kv_heads * Dh,
                             device)
        self.o_proj = _dense(c, "o_proj", c.n_heads * Dh, c.d_model, device)

    def forward(self, x, rope_table, padding_mask=None, cache=None,
                cache_index=0, block_tables=None):
        c = self.c
        B, T, _ = x.shape
        Dh = c.head_dim
        # heads by the projections' output: under tensor parallelism a
        # rank holds a share of them
        q = self.q_proj(x).view(B, T, -1, Dh)
        k = self.k_proj(x).view(B, T, -1, Dh)
        v = self.v_proj(x).view(B, T, -1, Dh)
        q = apply_rope(q, rope_table, cache_index)
        k = apply_rope(k, rope_table, cache_index)
        rep = q.shape[2] // k.shape[2]
        if cache is None:
            if rep != 1:  # GQA: repeat the kv heads
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = dot_product_attention(q, k, v, causal=True,
                                        padding_mask=padding_mask,
                                        impl=c.attention_impl)
            return self.o_proj(out.reshape(B, T, -1))
        ck, cv = cache["k"], cache["v"]
        dev = x.device

        if block_tables is not None:
            bs = ck.shape[1]
            MB = block_tables.shape[1]
            L = MB * bs
            if isinstance(cache_index, torch.Tensor) and cache_index.dim():
                base = cache_index.to(dev, torch.int32)
            else:
                base = torch.full((B,), int(cache_index), dtype=torch.int32,
                                  device=dev)
            cols = base[:, None].long() + torch.arange(T, device=dev)[None, :]
            # physical address of each new position; anything the table
            # does not cover lands in the null block, where garbage
            # (bucket padding, dead lanes) is harmless by contract
            phys = torch.where(
                cols < L,
                torch.gather(block_tables.long(), 1,
                             (cols // bs).clamp(0, MB - 1)),
                torch.zeros_like(cols))
            off = cols % bs
            # in place: the pool is the engine's one KV buffer
            ck.index_put_((phys, off), k.to(ck.dtype))
            cv.index_put_((phys, off), v.to(cv.dtype))
            out = paged_attention(q.to(ck.dtype).contiguous(), ck, cv,
                                  block_tables, base).to(q.dtype)
        else:
            S = ck.shape[1]
            kv_pos = torch.arange(S, device=dev)
            if isinstance(cache_index, torch.Tensor) and cache_index.dim():
                # per-row depths: batched scatter at row b's
                # cache_index[b], per-row causal mask
                idx = cache_index.to(dev).long()
                rows = torch.arange(B, device=dev)[:, None].expand(B, T)
                cols = idx[:, None] + torch.arange(T, device=dev)[None, :]
                ck.index_put_((rows, cols), k.to(ck.dtype))
                cv.index_put_((rows, cols), v.to(cv.dtype))
                mask = kv_pos[None, None, :] <= cols[:, :, None]  # [B, T, S]
            else:
                i = int(cache_index)
                ck[:, i:i + T] = k.to(ck.dtype)
                cv[:, i:i + T] = v.to(cv.dtype)
                q_pos = i + torch.arange(T, device=dev)
                mask = kv_pos[None, :] <= q_pos[:, None]         # [T, S]
            out = grouped_cache_attention(q, ck, cv, mask, rep)
        return self.o_proj(out.reshape(B, T, c.n_heads * Dh))


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        self.gate_proj = _dense(c, "gate_proj", c.d_model, c.ff_dim, device)
        self.up_proj = _dense(c, "up_proj", c.d_model, c.ff_dim, device)
        self.down_proj = _dense(c, "down_proj", c.ff_dim, c.d_model, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def _norm(c: LlamaConfig, device) -> RMSNorm:
    return RMSNorm(c.d_model, c.norm_eps, c.norm_impl, c.compute_dtype,
                   device)


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        self.input_norm = _norm(c, device)
        self.attn = LlamaAttention(c, device)
        self.post_attn_norm = _norm(c, device)
        self.mlp = LlamaMLP(c, device)

    def forward(self, x, rope_table, padding_mask=None, cache=None,
                cache_index=0, block_tables=None):
        h = self.input_norm(x)
        x = x + self.attn(h, rope_table, padding_mask, cache, cache_index,
                          block_tables)
        return x + self.mlp(self.post_attn_norm(x))


def init_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
               dtype=None, device=None) -> list[dict]:
    """Per-layer contiguous KV buffers [batch, max_len, Hkv, D]."""
    max_len = max_len or cfg.max_len
    if max_len > cfg.max_len:
        raise ValueError(
            f"cache max_len {max_len} exceeds model max_len {cfg.max_len}")
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.compute_dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     dtype=None, device=None) -> list[dict]:
    """Per-layer pooled KV [num_blocks, block_size, Hkv, D]: block 0 is
    the null block (serve/blocks.py routes masked writes there),
    1..num_blocks-1 are allocatable."""
    dev = resolve_device(device)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.compute_dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.n_layers)]


def paged_cache_block_bytes(cfg: LlamaConfig, block_size: int,
                            dtype=None) -> int:
    """Device bytes one physical block costs across all layers (K and V)."""
    dt = dtype or cfg.compute_dtype
    itemsize = torch.empty((), dtype=dt).element_size()
    return (2 * cfg.n_layers * block_size * cfg.n_kv_heads
            * cfg.head_dim * itemsize)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table. Under tensor parallelism the table is
    a DTensor split over `model` on its d columns (the reference's
    `embed_tokens/embedding` rule, P(None, model)): each rank looks up
    its columns and the pieces are gathered, so every rank holds whole
    rows; the gradient goes back to each rank's columns."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(table, DTensor):
        return table[ids]
    rows = table.to_local()[ids]
    out = DTensor.from_local(rows, table.device_mesh, [Shard(-1)],
                             run_check=False)
    return out.redistribute(table.device_mesh, [Replicate()]).to_local()


class Llama(nn.Module):
    """input_ids [B, T] → logits fp32 [B, T, vocab] (cache-free, with
    gradients), or (logits, cache) with a cache (no gradients).

    Weights are allocated uninitialised on `device` (None = cuda:0):
    fill them with `init_params(generator)` or `load_state_dict`
    (`params_from_jax`); adapters, when `lora_rank > 0`, with
    `load_lora`."""

    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        dt = cfg.compute_dtype
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=dt, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, dev) for _ in range(cfg.n_layers)])
        self.final_norm = _norm(cfg, dev)
        self.lm_head = make_dense(cfg, _Dense, cfg.d_model, cfg.vocab_size,
                                  dev)
        self.register_buffer(
            "rope", rope_frequencies(cfg.head_dim, cfg.max_len,
                                     cfg.rope_theta, dev),
            persistent=False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llama":
        """normal(0.02) for every projection and the embedding, ones for
        the norms, drawn from `generator` (on the weights' device) in
        parameter order. Adapters are left alone (`load_lora`)."""
        for name, p in self.named_parameters():
            if name.endswith(("lora_a", "lora_b")):
                continue
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def lora_params(self) -> dict[str, dict[str, nn.Parameter]]:
        """The live adapters, keyed by JAX kernel path
        (`models.lora`'s flat adapter dict)."""
        out = {}
        for name, mod in self.named_modules():
            if isinstance(mod, LoraDense):
                out[_jax_kernel_path(name)] = {"a": mod.lora_a,
                                               "b": mod.lora_b}
        return out

    @torch.no_grad()
    def load_lora(self, lora: dict[str, dict[str, torch.Tensor]]) -> "Llama":
        """Copy a flat adapter dict into the adapters, which keep their
        own dtype; every adapter must be given."""
        live = self.lora_params()
        if set(live) != set(lora):
            raise ValueError(f"adapter paths differ: model has "
                             f"{sorted(live)[:4]}..., got "
                             f"{sorted(lora)[:4]}...")
        for path, ab in live.items():
            for name in ("a", "b"):
                ab[name].copy_(lora[path][name])
        return self

    def forward(self, input_ids, padding_mask=None, cache=None,
                cache_index=0, block_tables=None):
        if cache is not None:
            with torch.no_grad():
                return self._decode(input_ids, cache, cache_index,
                                    block_tables)
        from hyperion_tpu_torch.runtime.mesh import seq_shard

        ids = torch.as_tensor(input_ids, device=self.device).long()
        T = ids.shape[1]
        # under a seq axis the ids are this rank's slice of each row:
        # RoPE takes global positions, the attention must be
        # sequence-parallel
        i, n = seq_shard()
        if n > 1 and self.cfg.attention_impl.partition(":")[0] not in (
                "ring", "ulysses"):
            raise ValueError(
                f"a seq axis of {n} shards each row's positions: "
                f"attention_impl {self.cfg.attention_impl!r} would attend "
                "within one shard; use 'ring' or 'ulysses'")
        if T * n > self.cfg.max_len:
            raise ValueError(f"sequence length {T * n} exceeds "
                             f"max_len {self.cfg.max_len} — the rope table "
                             "has no rows past max_len")
        if padding_mask is not None:
            padding_mask = torch.as_tensor(padding_mask, device=self.device)
        x = embed_lookup(self.embed_tokens, ids)
        policy = self.cfg.remat_policy
        for layer in self.layers:
            x = apply_remat(layer, policy)(x, self.rope, padding_mask, None,
                                           i * T)
        x = self.final_norm(x)
        return self.lm_head(x).float()

    def _decode(self, input_ids, cache, cache_index, block_tables):
        ids = torch.as_tensor(input_ids, device=self.device).long()
        if block_tables is not None:
            block_tables = torch.as_tensor(
                block_tables, device=self.device).to(torch.int32)
        if isinstance(cache_index, (torch.Tensor, np.ndarray)):
            cache_index = torch.as_tensor(cache_index, device=self.device)
            if cache_index.dim() == 0:
                cache_index = int(cache_index)
        x = embed_lookup(self.embed_tokens, ids)
        for layer, layer_cache in zip(self.layers, cache):
            x = layer(x, self.rope, None, layer_cache, cache_index,
                      block_tables)
        x = self.final_norm(x)
        return self.lm_head(x).float(), cache


# --- weight interchange with the JAX package -------------------------

_LAYER_MAP = {
    ("input_norm", "weight"): "input_norm.weight",
    ("post_attn_norm", "weight"): "post_attn_norm.weight",
    ("attn", "q_proj", "kernel"): "attn.q_proj.weight",
    ("attn", "k_proj", "kernel"): "attn.k_proj.weight",
    ("attn", "v_proj", "kernel"): "attn.v_proj.weight",
    ("attn", "o_proj", "kernel"): "attn.o_proj.weight",
    ("mlp", "gate_proj", "kernel"): "mlp.gate_proj.weight",
    ("mlp", "up_proj", "kernel"): "mlp.up_proj.weight",
    ("mlp", "down_proj", "kernel"): "mlp.down_proj.weight",
}


def _jax_kernel_path(module_name: str) -> str:
    """"layers.3.attn.q_proj" → "layer_3/attn/q_proj/kernel"."""
    _, i, *rest = module_name.split(".")
    return "/".join([f"layer_{i}", *rest, "kernel"])


def _kernel_shape(path: tuple, cfg: LlamaConfig) -> tuple:
    """The JAX kernel shape of a layer projection."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"q_proj": (d, H, Dh), "k_proj": (d, Hkv, Dh),
            "v_proj": (d, Hkv, Dh), "o_proj": (H, Dh, d),
            "gate_proj": (d, cfg.ff_dim), "up_proj": (d, cfg.ff_dim),
            "down_proj": (cfg.ff_dim, d)}[path[1]]


def jax_kernel_shapes(cfg: LlamaConfig) -> dict[str, tuple]:
    """"/"-joined JAX param path → shape, for every parameter of the
    JAX Llama: what `models.lora.init_lora_params` matches targets
    against."""
    shapes = {"embed_tokens/embedding": (cfg.vocab_size, cfg.d_model),
              "final_norm/weight": (cfg.d_model,),
              "lm_head/kernel": (cfg.d_model, cfg.vocab_size)}
    for i in range(cfg.n_layers):
        for path in _LAYER_MAP:
            shapes["/".join((f"layer_{i}", *path))] = (
                (cfg.d_model,) if path[-1] == "weight"
                else _kernel_shape(path, cfg))
    return shapes


def _weight_from_kernel(a: np.ndarray, contract: int) -> np.ndarray:
    """A flax kernel [*in, *out] ([H, Dh, d] for o_proj, whose first
    `contract` = 2 axes contract) as a [out, in] weight."""
    k = int(np.prod(a.shape[:contract]))
    return np.ascontiguousarray(a.reshape(k, -1).T)


def _contract(path: tuple) -> int:
    return 2 if path[-2] == "o_proj" else 1


def params_from_jax(tree: dict, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """Map the JAX Llama's nested param tree (numpy arrays — from
    `jax.device_get` or the port's `checkpoint.io.load_gathered`) onto
    this module's `state_dict` names. Flax kernels are [in, out] and
    become [out, in]; q/k/v_proj kernels are [d, H, Dh] and o_proj is
    [H, Dh, d], flattened to the 2-D projections here. Tensors stay
    fp32 on the CPU: `load_state_dict` casts and moves them. An int8
    tree (`quant="int8"`: `kernel_q` and `kernel_scale` in place of
    `kernel`) maps to `weight_q` (int8 [out, in]) and `weight_scale`
    (fp32 [out])."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())

    def dense(node: dict, name: str, contract: int) -> dict:
        if "kernel_q" in node:
            return {f"{name}.weight_q": torch.from_numpy(_weight_from_kernel(
                        np.asarray(node["kernel_q"], np.int8), contract)),
                    f"{name}.weight_scale": t(node["kernel_scale"]).reshape(
                        -1)}
        return {f"{name}.weight": torch.from_numpy(_weight_from_kernel(
            np.asarray(node["kernel"], np.float32), contract))}

    sd = {
        "embed_tokens": t(tree["embed_tokens"]["embedding"]),
        "final_norm.weight": t(tree["final_norm"]["weight"]),
        **dense(tree["lm_head"], "lm_head", 1),
    }
    for i in range(cfg.n_layers):
        layer = tree[f"layer_{i}"]
        for path, name in _LAYER_MAP.items():
            node = layer
            for key in path[:-1]:
                node = node[key]
            if path[-1] == "kernel":
                sd.update(dense(node, f"layers.{i}.{name[:-len('.weight')]}",
                                _contract(path)))
            else:
                sd[f"layers.{i}.{name}"] = t(node[path[-1]])
    return sd


def params_to_jax(model: Llama, named: dict | None = None) -> dict:
    """The inverse of `params_from_jax` over the base weights (adapters
    left out): the JAX Llama's nested tree of fp32 numpy arrays (int8
    `kernel_q` beside fp32 `kernel_scale` for a quantized model), the
    tree `hyperion_tpu/checkpoint/io.py`'s `export_gathered` writes.
    `named`: the weights by parameter name, when not the model's own
    (a sharded model's, gathered)."""
    cfg = model.cfg
    sd = model.state_dict() if named is None else named

    def a(p) -> np.ndarray:
        return p.detach().float().cpu().numpy()

    def dense(name: str, shape: tuple, contract: int) -> dict:
        if f"{name}.weight_q" in sd:
            q = sd[f"{name}.weight_q"].detach().cpu().numpy()
            scale = a(sd[f"{name}.weight_scale"])
            return {"kernel_q": np.ascontiguousarray(q.T.reshape(shape)),
                    "kernel_scale": scale.reshape((1,) * contract
                                                  + shape[contract:])}
        return {"kernel": np.ascontiguousarray(
            a(sd[f"{name}.weight"]).T.reshape(shape))}

    tree = {"embed_tokens": {"embedding": a(sd["embed_tokens"])},
            "final_norm": {"weight": a(sd["final_norm.weight"])},
            "lm_head": dense("lm_head", (cfg.d_model, cfg.vocab_size), 1)}
    for i in range(cfg.n_layers):
        layer: dict = {}
        for path, name in _LAYER_MAP.items():
            node = layer
            for key in path[:-1]:
                node = node.setdefault(key, {})
            if path[-1] == "kernel":
                node.update(dense(f"layers.{i}.{name[:-len('.weight')]}",
                                  _kernel_shape(path, cfg), _contract(path)))
            else:
                node[path[-1]] = a(sd[f"layers.{i}.{name}"])
        tree[f"layer_{i}"] = layer
    return tree


# --- HF checkpoint interchange (local files only) --------------------

_HF_LAYER_MAP = {
    "input_layernorm.weight": ("input_norm", "weight"),
    "post_attention_layernorm.weight": ("post_attn_norm", "weight"),
    "self_attn.q_proj.weight": ("attn", "q_proj", "kernel"),
    "self_attn.k_proj.weight": ("attn", "k_proj", "kernel"),
    "self_attn.v_proj.weight": ("attn", "v_proj", "kernel"),
    "self_attn.o_proj.weight": ("attn", "o_proj", "kernel"),
    "mlp.gate_proj.weight": ("mlp", "gate_proj", "kernel"),
    "mlp.up_proj.weight": ("mlp", "up_proj", "kernel"),
    "mlp.down_proj.weight": ("mlp", "down_proj", "kernel"),
}


def params_from_hf_state_dict(state: dict, cfg: LlamaConfig) -> dict:
    """An HF Llama state dict (torch tensors or arrays) → the JAX
    Llama's nested param tree of fp32 numpy arrays (`params_from_jax`
    takes it from there), as the reference maps it: HF linear weights
    [out, in] become kernels [in, out], q/k/v reshaped to (in, heads,
    head_dim) and o_proj to (heads, head_dim, out)."""

    def arr(v) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        return np.asarray(v, np.float32)

    params: dict = {
        "embed_tokens": {"embedding": arr(state["model.embed_tokens.weight"])},
        "final_norm": {"weight": arr(state["model.norm.weight"])},
        "lm_head": {"kernel": arr(state["lm_head.weight"]).T},
    }
    for i in range(cfg.n_layers):
        layer: dict = {}
        for hf_name, path in _HF_LAYER_MAP.items():
            w = arr(state[f"model.layers.{i}.{hf_name}"])
            if path[-1] == "kernel":
                w = w.T.reshape(_kernel_shape(path, cfg))
            node = layer
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = w
        params[f"layer_{i}"] = layer
    return params


def load_hf_checkpoint(model_dir: str | Path, cfg: LlamaConfig) -> dict | None:
    """HF weights from a local directory (`*.safetensors`, else
    `pytorch_model*.bin` shards) as the JAX param tree; None when the
    directory holds neither. `.bin` shards are read with
    `torch.load(weights_only=True)`; `.safetensors` need the
    `safetensors` package, and without it this raises."""
    model_dir = Path(model_dir)
    state: dict = {}
    sf = sorted(model_dir.glob("*.safetensors"))
    if sf:
        try:
            from safetensors.torch import load_file
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"{model_dir} holds .safetensors weights, which need the "
                "'safetensors' package (not installed)") from e
        for f in sf:
            state.update(load_file(str(f)))
    else:
        bins = sorted(model_dir.glob("pytorch_model*.bin"))
        if not bins:
            return None
        for f in bins:
            state.update(torch.load(f, map_location="cpu", weights_only=True))
    return params_from_hf_state_dict(state, cfg)
