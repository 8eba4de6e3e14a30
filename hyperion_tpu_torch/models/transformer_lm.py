"""Transformer language models in PyTorch —
`hyperion_tpu/models/transformer_lm.py:37-232`.

`simple_lm_config()` is the `language_ddp` model (d 256, 4 heads, 2
pre-LayerNorm blocks, ff 1024, ReLU, GPT-2 vocab, causal);
`gpt2_lm_config()` the GPT-2-shaped variant (d 768, 12 heads, 4 layers,
ff 3072, GELU). Module and parameter names follow the flax tree
(`tok_emb`, `pos_emb`, `block_{i}/{ln1,attn,ln2,fc1,fc2}`, `ln_f`,
`lm_head`); dense weights are PyTorch's [out, in], and
`params_from_jax` / `params_to_jax` convert to and from flax's layouts.

Precision follows the flax modules' `dtype=compute_dtype` by explicit
casts, not `torch.autocast`: parameters stay in their own dtype (fp32
masters under the "bf16" policy) and are cast to the compute dtype at
use; embeddings, dense outputs, attention and the residual stream are
in the compute dtype; each LayerNorm is fed that dtype and computes its
statistics in fp32; logits are cast to fp32 at the end (`:214` there).
So each kernel sees the dtypes its JAX counterpart sees.

`norm_impl` picks the norm: "xla" is flax's `nn.LayerNorm` arithmetic
(fp32 statistics by E[x^2] - E[x]^2, clipped at 0), "pallas" the fused
kernel (`ops.fused_norm.fused_layernorm`, two-pass variance); both keep
fp32 `scale`/`bias` with eps 1e-6. `attention_impl` goes to
`ops.attention.dot_product_attention`.

Dropout draws from the `torch.Generator` the caller passes; it cannot
reproduce JAX's dropout bits. `remat` wraps each block with
`precision.remat.apply_remat`; a rematerialized block's
recompute restarts the dropout generator where the block's first run
found it, so it redraws the same masks. `quant="int8"` is not ported
(ROADMAP A9b) and raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.data.text import GPT2_VOCAB_SIZE
from hyperion_tpu_torch.ops.attention import dot_product_attention
from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
from hyperion_tpu_torch.precision.remat import apply_remat, normalize_remat

LN_EPS = 1e-6  # flax nn.LayerNorm's default, used by both impls


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = GPT2_VOCAB_SIZE
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    ff_dim: int = 1024
    max_len: int = 128
    dropout: float = 0.1
    activation: str = "relu"       # relu | gelu
    attention_impl: str = "xla"    # xla | pallas (flash kernel) | auto
    norm_impl: str = "xla"         # xla | pallas (fused_layernorm kernel)
    causal: bool = True            # False → bidirectional encoder blocks
    remat: bool | str = False      # precision.remat policy, per block
    dtype: str = "float32"         # compute dtype; params stay fp32
    quant: str = "none"            # not ported (ROADMAP A9b)

    def __post_init__(self):
        normalize_remat(self.remat)
        if self.quant != "none":
            raise NotImplementedError(
                "int8 weight quant is not ported yet (ROADMAP A9b)")
        if self.activation not in ("relu", "gelu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.norm_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown norm_impl {self.norm_impl!r}")

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


def simple_lm_config(**kw) -> TransformerLMConfig:
    return TransformerLMConfig(**kw)


def gpt2_lm_config(**kw) -> TransformerLMConfig:
    base = dict(d_model=768, n_heads=12, n_layers=4, ff_dim=3072,
                activation="gelu")
    base.update(kw)
    return TransformerLMConfig(**base)


class Dense(nn.Module):
    """flax `DenseGeneral` as this model uses it: weight [out, in] and
    bias [out] in fp32, both cast to the compute dtype at use."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Embed(nn.Module):
    """flax `nn.Embed(dtype=...)`: the fp32 table cast to the compute
    dtype, then looked up."""

    def __init__(self, num: int, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, d, device=device))

    def forward(self, ids):
        return F.embedding(ids, self.embedding.to(self.dtype))


def flax_layer_norm(x, scale, bias, *, eps: float, dtype: torch.dtype):
    """flax `nn.LayerNorm` arithmetic: mean and E[x^2] in fp32, variance
    E[x^2] - mean^2 clipped at 0, `(x - mean) * (rsqrt(var + eps) *
    scale) + bias`, cast to `dtype`."""
    h = x.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0)
    y = (h - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=compute_dtype)` — the "xla" norm."""

    def __init__(self, d: int, dtype: torch.dtype, device, eps: float = LN_EPS):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return flax_layer_norm(x, self.scale, self.bias, eps=self.eps,
                               dtype=self.dtype)


class FusedLayerNorm(LayerNorm):
    """The same `scale`/`bias` params behind the fused kernel — the norm
    half of the `jit+pallas` tier. Input cast to the compute dtype."""

    def forward(self, x):
        return fused_layernorm(x.to(self.dtype), self.scale.float(),
                               self.bias.float(), eps=self.eps)


def _norm(cfg: TransformerLMConfig, device) -> LayerNorm:
    cls = FusedLayerNorm if cfg.norm_impl == "pallas" else LayerNorm
    return cls(cfg.d_model, cfg.compute_dtype, device)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, kept values
    scaled by 1 / (1 - rate) in x's dtype."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class MHA(nn.Module):
    def __init__(self, cfg: TransformerLMConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd, dt = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.compute_dtype
        self.q_proj = Dense(d, hd, dt, device)
        self.k_proj = Dense(d, hd, dt, device)
        self.v_proj = Dense(d, hd, dt, device)
        self.o_proj = Dense(hd, d, dt, device)

    def forward(self, x, padding_mask):
        # heads by the projections' output: under tensor parallelism a
        # rank holds n_heads / model of them
        c = self.cfg
        B, T, _ = x.shape
        q, k, v = (p(x).view(B, T, -1, c.head_dim)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention(q, k, v, causal=c.causal,
                                    padding_mask=padding_mask,
                                    impl=c.attention_impl)
        return self.o_proj(out.reshape(B, T, -1))


class Block(nn.Module):
    def __init__(self, cfg: TransformerLMConfig, device):
        super().__init__()
        dt = cfg.compute_dtype
        self.act = (F.relu if cfg.activation == "relu"
                    else lambda h: F.gelu(h, approximate="tanh"))
        self.ln1 = _norm(cfg, device)
        self.attn = MHA(cfg, device)
        self.ln2 = _norm(cfg, device)
        self.fc1 = Dense(cfg.d_model, cfg.ff_dim, dt, device)
        self.fc2 = Dense(cfg.ff_dim, cfg.d_model, dt, device)

    def forward(self, x, padding_mask, drop):
        h = drop(self.attn(self.ln1(x), padding_mask))
        x = x + h
        h = self.fc2(self.act(self.fc1(self.ln2(x))))
        return x + drop(h)


class TransformerLM(nn.Module):
    """input_ids [B, T] → logits fp32 [B, T, vocab].

    Parameters are allocated on `device` (None = cuda:0) in fp32 and
    filled by `init_params(generator)` or `load_state_dict`
    (`params_from_jax`)."""

    def __init__(self, cfg: TransformerLMConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        dt = cfg.compute_dtype
        self.tok_emb = Embed(cfg.vocab_size, cfg.d_model, dt, dev)
        self.pos_emb = Embed(cfg.max_len, cfg.d_model, dt, dev)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, dev))
        self.ln_f = _norm(cfg, dev)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dt, dev)

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerLM":
        """The flax initializers, drawn from `generator` (on the
        parameters' device) in parameter order (`init_lm_param`)."""
        for name, p in self.named_parameters():
            init_lm_param(name, p, generator)
        return self

    def forward(self, input_ids, padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """`deterministic=False` applies dropout, drawing from
        `generator`."""
        c = self.cfg
        drop = dropout_fn(c, deterministic, generator)
        x = embed(self, input_ids, drop)
        for block in self.blocks:
            x = _remat_block(block, c.remat_policy, generator)(
                x, padding_mask, drop)
        return self.lm_head(self.ln_f(x)).float()


@torch.no_grad()
def init_lm_param(name: str, p: torch.Tensor,
                  generator: torch.Generator) -> None:
    """One parameter of the LMs by the flax initializer its name calls
    for: normal(0.02) embeddings and head; xavier-uniform attention
    projections and MoE routers and expert kernels (over the last two
    dims, leading dims stacked); lecun-normal (truncated) MLP; zero
    biases, unit norm scales."""
    mod, leaf = name.rsplit(".", 1)
    last = mod.split(".")[-1]
    if leaf == "embedding" or last == "lm_head" and leaf == "weight":
        p.normal_(0.0, 0.02, generator=generator)
    elif leaf == "weight" and last.endswith("_proj") \
            or leaf in ("router", "wi", "wo"):
        limit = math.sqrt(6.0 / (p.shape[-2] + p.shape[-1]))
        p.uniform_(-limit, limit, generator=generator)
    elif leaf == "weight":  # fc1 / fc2: lecun_normal over [out, in]
        std = math.sqrt(1.0 / p.shape[-1]) / .87962566103423978
        nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    elif leaf == "scale":
        p.fill_(1.0)
    else:
        p.zero_()


def dropout_fn(c: TransformerLMConfig, deterministic: bool,
               generator: torch.Generator | None):
    """The blocks' dropout: the identity when deterministic (or rate
    0), else flax `nn.Dropout` drawing from `generator`."""
    if deterministic or c.dropout == 0.0:
        return lambda h: h
    if generator is None:
        raise ValueError("dropout needs a torch.Generator")
    return lambda h: dropout(h, c.dropout, generator)


def embed(model: nn.Module, input_ids, drop) -> torch.Tensor:
    """Token plus positional embeddings of `model` (its `tok_emb`,
    `pos_emb`, `cfg` and `device`), dropout applied. Under a seq axis
    the ids are this rank's slice of each row, and the positions are
    global (`runtime/mesh.py` `seq_shard`), so the attention must be
    sequence-parallel ("ring" or "ulysses")."""
    from hyperion_tpu_torch.runtime.mesh import seq_shard

    c = model.cfg
    T = input_ids.shape[1]
    i, n = seq_shard()
    if n > 1 and c.attention_impl.partition(":")[0] not in ("ring",
                                                            "ulysses"):
        raise ValueError(
            f"a seq axis of {n} shards each row's positions: attention_impl "
            f"{c.attention_impl!r} would attend within one shard; use "
            "'ring' or 'ulysses'")
    if T * n > c.max_len:
        raise ValueError(
            f"sequence length {T * n} exceeds max_len {c.max_len} — the "
            "positional table has no rows past max_len")
    ids = input_ids.to(model.device).long()
    pos = torch.arange(i * T, (i + 1) * T, device=model.device)
    return drop(model.tok_emb(ids) + model.pos_emb(pos)[None])


def _remat_block(block: Block, policy: str,
                 generator: torch.Generator | None):
    """`block` wrapped per the remat policy. With a dropout generator,
    each run of the wrapped block (the first, and the recompute in
    backward) starts from the generator state the first run found."""
    if policy == "none" or generator is None:
        return apply_remat(block, policy)
    state = generator.get_state()

    def run(*args):
        generator.set_state(state)
        return block(*args)

    return apply_remat(run, policy)


# --- weight interchange with the JAX package -------------------------

_SPLIT_HEADS = ("q_proj", "k_proj", "v_proj")


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def params_from_jax(tree: dict, cfg: TransformerLMConfig
                    ) -> dict[str, torch.Tensor]:
    """Map the flax TransformerLM param tree (numpy arrays — from
    `jax.device_get` or `checkpoint.io.load_gathered`) onto this
    module's `state_dict`. Kernels [in, ...out] become weights [out,
    in]: q/k/v_proj kernels are [d, H, Dh] with [H, Dh] biases, o_proj
    is [H, Dh, d], lm_head [d, V]. Tensors come out fp32 on the CPU;
    `load_state_dict` moves them."""
    sd = {}
    for path, a in _flatten(tree).items():
        *mods, leaf = path
        a = np.array(a, dtype=np.float32)  # a writable copy
        if leaf == "kernel":
            a = a.reshape(-1, a.shape[-1]) if mods[-1] == "o_proj" \
                else a.reshape(a.shape[0], -1)
            a, leaf = a.T, "weight"
        elif leaf == "bias" and mods[-1] in _SPLIT_HEADS:
            a = a.reshape(-1)
        sd[".".join([*mods, leaf])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return sd


def params_to_jax(model: TransformerLM) -> dict:
    """The inverse of `params_from_jax`: the flax-layout nested tree of
    fp32 numpy arrays, the tree `hyperion_tpu/checkpoint/io.py`'s
    `export_gathered` writes."""
    return state_to_jax(model.state_dict(), model.cfg)


def state_to_jax(named: dict[str, torch.Tensor],
                 cfg: TransformerLMConfig) -> dict:
    """Tensors named as this module's `state_dict` (params, or their
    gradients) → the flax-layout nested tree of fp32 numpy arrays."""
    H, Dh = cfg.n_heads, cfg.head_dim
    tree: dict = {}
    for name, p in named.items():
        *mods, leaf = name.split(".")
        a = p.detach().float().cpu().numpy()
        if leaf == "weight":
            a = a.T
            if mods[-1] in _SPLIT_HEADS:
                a = a.reshape(a.shape[0], H, Dh)
            elif mods[-1] == "o_proj":
                a = a.reshape(H, Dh, a.shape[-1])
            leaf = "kernel"
        elif leaf == "bias" and mods[-1] in _SPLIT_HEADS:
            a = a.reshape(H, Dh)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
