"""Pipeline-parallel Transformer LM — `hyperion_tpu/models/pipeline_lm.py`.

The TransformerLM's blocks, unchanged in their math, held as ONE
stacked block: `stages` is a `transformer_lm.Block` whose every
parameter is stacked [n_stages, layers_per_stage, ...] (the flax tree's
`stages/` leaves, torch layouts past the two stacking dims). Layer
(s, l) runs that Block's forward on the slices [s, l]
(`torch.func.functional_call`). The embeddings, final norm and head
stay whole on every stage, as in the reference.

With no active mesh, or a pipe axis of 1, the stages run in order on
this rank (each layer under the config's remat policy): that is the
reference the pipeline is held to, and with the unstacked weights it is
a TransformerLM of n_stages * layers_per_stage layers, bit for bit. With
a pipe axis of n_stages ranks the stage leaves are DTensors split on
dim 0 over `pipe` (`parallel.partition.apply_stacked`), and the blocks
run through the GPipe schedule (`parallel.pipeline.gpipe_apply`) over
n_microbatches microbatches, each rank its own stage. When the stage
leaves are split over `fsdp` or `model` too, each layer is gathered
inside the tick (`gather_layer`, the reference's `gpipe_apply_layers`
with fsdp, its whole-stage gather with model).

Dropout draws from the caller's generator; the pipeline's backward
replays each tick's generator state, so its recompute redraws the same
masks. It cannot match JAX's bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.models import transformer_lm as tlm
from hyperion_tpu_torch.models.transformer_lm import (
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
from hyperion_tpu_torch.parallel.pipeline import gather_layer, gpipe_apply


@dataclasses.dataclass(frozen=True)
class PipelineLMConfig:
    base: TransformerLMConfig
    n_stages: int = 2
    n_microbatches: int = 4

    def __post_init__(self):
        if self.base.n_layers % self.n_stages:
            raise ValueError(f"n_layers {self.base.n_layers} not divisible "
                             f"by n_stages {self.n_stages}")

    @property
    def layers_per_stage(self) -> int:
        return self.base.n_layers // self.n_stages


def _stacked_block(c: TransformerLMConfig, S: int, lps: int,
                   device) -> Block:
    """A Block whose parameters are [S, lps, *shape], uninitialised."""
    block = Block(c, "meta")
    for name, p in list(block.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        setattr(block.get_submodule(mod), leaf, nn.Parameter(
            torch.empty(S, lps, *p.shape, device=device)))
    return block


class PipelinedLM(nn.Module):
    """input_ids [B, T] → logits fp32 [B, T, vocab], the TransformerLM's
    call surface. Parameters on `device` (None = cuda:0), fp32."""

    def __init__(self, cfg: PipelineLMConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.pipe_cfg = cfg
        self.cfg = c = cfg.base
        self.device = dev
        dt = c.compute_dtype
        self.tok_emb = Embed(c.vocab_size, c.d_model, dt, dev)
        self.pos_emb = Embed(c.max_len, c.d_model, dt, dev)
        self.stages = _stacked_block(c, cfg.n_stages, cfg.layers_per_stage,
                                     dev)
        self.ln_f = _norm(c, dev)
        self.lm_head = Dense(c.d_model, c.vocab_size, dt, dev)
        self.stage_names = [n for n, _ in self.stages.named_parameters()]

    def with_base(self, base: TransformerLMConfig) -> PipelineLMConfig:
        """This model's config over another base (a twin's)."""
        return dataclasses.replace(self.pipe_cfg, base=base)

    @property
    def blocks(self) -> list:
        """No block is a module of its own (FSDP2 wraps the root only;
        the stage leaves are gathered by the pipeline)."""
        return []

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "PipelinedLM":
        """The TransformerLM's initializers in the TransformerLM's
        order (embeddings, then layer by layer every block parameter,
        then the final norm and head): from the same generator state the
        weights equal a TransformerLM's of as many layers."""
        for name in ("tok_emb.embedding", "pos_emb.embedding"):
            init_lm_param(name, self.get_parameter(name), generator)
        S, lps = self.pipe_cfg.n_stages, self.pipe_cfg.layers_per_stage
        stacked = [self.stages.get_parameter(n) for n in self.stage_names]
        for i in range(S * lps):
            for name, p in zip(self.stage_names, stacked):
                init_lm_param(name, p[i // lps, i % lps], generator)
        for name in ("ln_f.scale", "ln_f.bias", "lm_head.weight",
                     "lm_head.bias"):
            init_lm_param(name, self.get_parameter(name), generator)
        return self

    def _layer(self, leaves: dict, x, pad, drop):
        return torch.func.functional_call(self.stages, leaves, (x, pad, drop))

    def forward(self, input_ids, padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        from hyperion_tpu_torch.runtime.mesh import (
            AbstractMesh,
            AxisName,
            active_mesh,
            axis_sizes,
        )

        c = self.cfg
        drop = dropout_fn(c, deterministic, generator)
        x = embed(self, input_ids, drop)
        if padding_mask is not None:
            padding_mask = padding_mask.to(x.device)
        mesh = active_mesh()
        pipe = (1 if mesh is None or isinstance(mesh, AbstractMesh)
                else axis_sizes(mesh)[AxisName.PIPE])
        stacked = [self.stages.get_parameter(n) for n in self.stage_names]
        S, lps = self.pipe_cfg.n_stages, self.pipe_cfg.layers_per_stage
        if pipe > 1:
            if pipe != S:
                raise ValueError(f"model has {S} stages but mesh pipe axis "
                                 f"is {pipe}")
            layouts = [(p.placements, p.device_mesh) for p in stacked]

            def stage_fn(params, x_mb, extras, m):
                pad = extras[0] if extras else None
                for li in range(lps):
                    leaves = {n: gather_layer(q[0, li], *lay) for n, q, lay
                              in zip(self.stage_names, params, layouts)}
                    x_mb = self._layer(leaves, x_mb, pad, drop)
                return x_mb

            x = gpipe_apply(
                stage_fn, [p.to_local() for p in stacked], x,
                mesh.get_group(AxisName.PIPE),
                n_microbatches=self.pipe_cfg.n_microbatches,
                extras=[] if padding_mask is None else [padding_mask],
                generator=None if deterministic or c.dropout == 0.0
                else generator)
        else:
            for i in range(S * lps):
                leaves = {n: p[i // lps, i % lps]
                          for n, p in zip(self.stage_names, stacked)}

                def layer(h, pad, drop, leaves=leaves):
                    return self._layer(leaves, h, pad, drop)

                x = _remat_block(layer, c.remat_policy, generator)(
                    x, padding_mask, drop)
        return self.lm_head(self.ln_f(x)).float()


# --- weight interchange with the JAX package -------------------------


def params_from_jax(tree: dict, cfg: PipelineLMConfig
                    ) -> dict[str, torch.Tensor]:
    """The flax PipelinedLM tree (its `stages/` leaves [S, lps, ...]) →
    this module's `state_dict`: the TransformerLM mapping per layer,
    restacked."""
    sd = tlm.params_from_jax({k: v for k, v in tree.items()
                              if k != "stages"}, cfg.base)
    S, lps = cfg.n_stages, cfg.layers_per_stage
    for path, a in tlm._flatten(tree["stages"]).items():
        a = np.asarray(a, np.float32)
        one = {}
        node = one
        for k in path[:-1]:
            node = node.setdefault(k, {})
        layers = []
        for i in range(S * lps):
            node[path[-1]] = a[i // lps, i % lps]
            (name, t), = tlm.params_from_jax(one, cfg.base).items()
            layers.append(t)
        sd[f"stages.{name}"] = torch.stack(layers).reshape(
            S, lps, *layers[0].shape)
    return sd


def state_to_jax(named: dict[str, torch.Tensor],
                 cfg: PipelineLMConfig) -> dict:
    """The inverse of `params_from_jax` for tensors named as this
    module's `state_dict` (whole, e.g. `checkpoint.io.gathered_state`):
    the flax tree of fp32 numpy arrays."""
    tree = tlm.state_to_jax({k: v for k, v in named.items()
                             if not k.startswith("stages.")}, cfg.base)
    S, lps = cfg.n_stages, cfg.layers_per_stage
    stages: dict = {}
    for name, t in named.items():
        if not name.startswith("stages."):
            continue
        body = name[len("stages."):]
        layers = [tlm._flatten(tlm.state_to_jax(
            {body: t[i // lps, i % lps]}, cfg.base)) for i in range(S * lps)]
        (path, _), = layers[0].items()
        a = np.stack([lay[path] for lay in layers])
        node = stages
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.reshape(S, lps, *a.shape[1:])
    tree["stages"] = stages
    return tree
