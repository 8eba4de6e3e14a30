"""Continuous-input Transformer encoder, the benchmark "CustomTransformer"
— `hyperion_tpu/models/encoder.py`.

The reference benchmark's encoder (d 512, 8 heads, 6 layers, ff 2048)
takes a raw [B, T, d_model] float tensor (no embedding) and is timed at
batch 32, seq 16 with an MSE loss. As in the JAX module it reuses the
LM's pre-LN `Block` (`models/transformer_lm.py`) with `causal=False`.
"""

from __future__ import annotations

import torch
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.models import transformer_lm as tlm
from hyperion_tpu_torch.precision.remat import apply_remat


def custom_transformer_config(**kw) -> tlm.TransformerLMConfig:
    base = dict(d_model=512, n_heads=8, n_layers=6, ff_dim=2048,
                activation="relu", causal=False, dropout=0.1)
    base.update(kw)
    return tlm.TransformerLMConfig(**base)


class TransformerEncoder(nn.Module):
    """A stack of bidirectional blocks over a continuous [B, T, D]
    input → fp32 [B, T, D]. Parameters (`block_{i}`) are allocated on
    `device` (None = cuda:0) in fp32; fill them with
    `init_params(generator)` or `load_state_dict(params_from_jax(...))`."""

    def __init__(self, cfg: tlm.TransformerLMConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", tlm.Block(cfg, dev))

    @property
    def blocks(self) -> list[tlm.Block]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerEncoder":
        for name, p in self.named_parameters():
            tlm.init_lm_param(name, p, generator)
        return self

    def forward(self, x, padding_mask=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        c = self.cfg
        if x.shape[-1] != c.d_model:
            raise ValueError(f"input dim {x.shape[-1]} != d_model {c.d_model}")
        drop = tlm.dropout_fn(c, deterministic, generator)
        x = torch.as_tensor(x, device=self.device).to(c.compute_dtype)
        # the reference remats every block fully whenever `remat` is set
        policy = "full" if c.remat else "none"
        for block in self.blocks:
            x = apply_remat(block, policy)(x, padding_mask, drop)
        return x.float()


def params_from_jax(tree: dict, cfg: tlm.TransformerLMConfig
                    ) -> dict[str, torch.Tensor]:
    """The flax encoder's param tree (numpy arrays) as this module's
    state dict: the blocks' leaves as `transformer_lm.params_from_jax`
    maps them."""
    return tlm.params_from_jax(tree, cfg)
