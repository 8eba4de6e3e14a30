"""MoE Transformer LM — `hyperion_tpu/models/moe_lm.py`: sparse FFN
layers with expert parallelism.

The dense `transformer_lm.Block` stays the backbone; every
`moe_every`-th block (block i with (i + 1) % moe_every == 0, named
`moe_block_{i}`) swaps its FFN for `ops.moe.moe_ffn`. Its norms are the
TransformerLM's (`norm_impl="pallas"`: the fused LayerNorm kernel), its
attention the same MHA, and its parameters the flax tree's: `router`
[d, E] and `experts/{wi, bi, wo, bo}` stacked [E, ...], in the flax
layout (`transformer_lm.params_from_jax` / `state_to_jax` carry them
unchanged). Under an expert axis the expert leaves are DTensors split
on dim 0 (`parallel.partition.apply_stacked`), and each block hands its
local experts to `moe_ffn` with the mesh's expert group.

`forward` returns the logits, as TransformerLM does; `apply_with_aux`
also returns the routed auxiliary loss: the mean of the MoE layers'
balance losses, scaled by `aux_weight`, which the trainer adds to the
LM loss. Each MoE block keeps its last call's routed and kept pick
counts (`dropped_share`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.models.transformer_lm import (
    MHA,
    Block,
    Dense,
    Embed,
    TransformerLMConfig,
    _norm,
    _remat_block,
    dropout_fn,
    embed,
    init_lm_param,
)
from hyperion_tpu_torch.ops.moe import MoEConfig, moe_ffn


@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    base: TransformerLMConfig
    moe: MoEConfig
    moe_every: int = 2     # every k-th block is sparse (1 = all MoE)
    aux_weight: float = 0.01

    def __post_init__(self):
        if self.moe.d_model != self.base.d_model:
            raise ValueError(f"moe.d_model {self.moe.d_model} != "
                             f"base.d_model {self.base.d_model}")


class ExpertBank(nn.Module):
    """The stacked [E, ...] expert FFN weights, fp32."""

    def __init__(self, moe: MoEConfig, device):
        super().__init__()
        E, d, f = moe.n_experts, moe.d_model, moe.ff_dim
        self.wi = nn.Parameter(torch.empty(E, d, f, device=device))
        self.bi = nn.Parameter(torch.zeros(E, f, device=device))
        self.wo = nn.Parameter(torch.empty(E, f, d, device=device))
        self.bo = nn.Parameter(torch.zeros(E, d, device=device))


def _moe_groups():
    """(expert group, the row groups, seq group) of the active mesh; a
    size-1 axis's group is None."""
    from hyperion_tpu_torch.runtime.mesh import (
        AbstractMesh,
        AxisName,
        active_mesh,
        axis_groups,
        axis_sizes,
    )

    mesh = active_mesh()
    if mesh is None or isinstance(mesh, AbstractMesh):
        return None, [], None
    s = axis_sizes(mesh)
    ep, seq = (mesh.get_group(a) if s[a] > 1 else None
               for a in (AxisName.EXPERT, AxisName.SEQ))
    return ep, axis_groups(mesh, AxisName.LM_ROWS), seq


def _local(p: torch.Tensor) -> torch.Tensor:
    """This rank's experts of a leaf split over `expert` (a DTensor),
    with autograd; the tensor itself otherwise."""
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


class MoEBlock(nn.Module):
    def __init__(self, cfg: TransformerLMConfig, moe: MoEConfig, device):
        super().__init__()
        self.moe = moe
        self.ln1 = _norm(cfg, device)
        self.attn = MHA(cfg, device)
        self.ln2 = _norm(cfg, device)
        self.router = nn.Parameter(torch.empty(cfg.d_model, moe.n_experts,
                                               device=device))
        self.experts = ExpertBank(moe, device)
        self.stats: dict = {}

    def forward(self, x, padding_mask, drop):
        h = drop(self.attn(self.ln1(x), padding_mask))
        x = x + h
        ep, rows, seq = _moe_groups()
        params = {"router": {"kernel": self.router},
                  "experts": {k: _local(getattr(self.experts, k))
                              for k in ("wi", "bi", "wo", "bo")}}
        y, aux = moe_ffn(params, self.ln2(x), self.moe,
                         padding_mask=padding_mask, expert_group=ep,
                         row_groups=rows, seq_group=seq, stats=self.stats)
        return x + drop(y), aux


class MoELM(nn.Module):
    """TransformerLM with sparse FFN layers: input_ids [B, T] → logits
    fp32 [B, T, vocab]; `apply_with_aux` adds the routed aux loss.
    Parameters are allocated on `device` (None = cuda:0) in fp32."""

    def __init__(self, cfg: MoELMConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.moe_cfg = cfg
        self.cfg = c = cfg.base
        self.device = dev
        dt = c.compute_dtype
        self.tok_emb = Embed(c.vocab_size, c.d_model, dt, dev)
        self.pos_emb = Embed(c.max_len, c.d_model, dt, dev)
        for i in range(c.n_layers):
            if (i + 1) % cfg.moe_every == 0:
                self.add_module(f"moe_block_{i}", MoEBlock(c, cfg.moe, dev))
            else:
                self.add_module(f"block_{i}", Block(c, dev))
        self.ln_f = _norm(c, dev)
        self.lm_head = Dense(c.d_model, c.vocab_size, dt, dev)

    @property
    def blocks(self) -> list[nn.Module]:
        return [getattr(self, f"moe_block_{i}"
                        if (i + 1) % self.moe_cfg.moe_every == 0
                        else f"block_{i}")
                for i in range(self.cfg.n_layers)]

    @property
    def moe_blocks(self) -> list[MoEBlock]:
        return [b for b in self.blocks if isinstance(b, MoEBlock)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "MoELM":
        """The flax initializers (`transformer_lm.init_lm_param`), drawn
        from `generator` in parameter order."""
        for name, p in self.named_parameters():
            init_lm_param(name, p, generator)
        return self

    def with_base(self, base: TransformerLMConfig) -> MoELMConfig:
        """This model's config over another base (a twin's)."""
        return dataclasses.replace(self.moe_cfg, base=base)

    def apply_with_aux(self, input_ids, padding_mask=None,
                       deterministic: bool = True,
                       generator: torch.Generator | None = None):
        """(logits, aux): aux is the mean of the MoE layers' balance
        losses times `aux_weight`. Through the module's call, so FSDP2's
        hooks run."""
        return self(input_ids, padding_mask, deterministic, generator,
                    with_aux=True)

    def forward(self, input_ids, padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None,
                with_aux: bool = False):
        """Logits, or (logits, aux) `with_aux`."""
        c = self.cfg
        drop = dropout_fn(c, deterministic, generator)
        x = embed(self, input_ids, drop)
        auxes = []
        for block in self.blocks:
            out = _remat_block(block, c.remat_policy, generator)(
                x, padding_mask, drop)
            if isinstance(block, MoEBlock):
                x, aux = out
                auxes.append(aux)
            else:
                x = out
        logits = self.lm_head(self.ln_f(x)).float()
        aux = (torch.stack(auxes).sum() / max(1, len(auxes)) if auxes
               else logits.new_zeros(()))
        aux = self.moe_cfg.aux_weight * aux
        return (logits, aux) if with_aux else logits

    def dropped_share(self) -> float:
        """The share of real top-k picks the last forward dropped for
        want of capacity, over every MoE layer (reads the device)."""
        routed = sum(float(b.stats["routed"]) for b in self.moe_blocks)
        kept = sum(float(b.stats["kept"]) for b in self.moe_blocks)
        return 1.0 - kept / routed if routed else 0.0
