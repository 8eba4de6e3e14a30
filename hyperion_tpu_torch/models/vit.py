"""Vision Transformer (ViT-B/16), the baseline benchmark's third model
— `hyperion_tpu/models/vit.py`.

ViT-B/16: 224 x 224 images, 16 x 16 patches, d 768, 12 layers of 12
heads, mlp 3072, 1000 classes. Images come in the reference's NHWC
layout; patchify is a strided convolution, run `channels_last` on the
card (the NHWC batch is that memory layout already, so no copy), whose
[B, d, h, w] output flattens row-major into [B, h*w, d] as flax's
[B, h, w, d] reshape does. A class token and learned positions, then
the LM's pre-LN `Block` (`models/transformer_lm.py`) with `causal=False`
(`attention_impl` and `norm_impl` reach the flash and fused-LayerNorm
kernels), a final LayerNorm and a dense head on the class token.
Precision follows the flax modules: fp32 parameters cast to the compute
dtype at use, fp32 logits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.models import transformer_lm as tlm
from hyperion_tpu_torch.precision.remat import apply_remat


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    ff_dim: int = 3072
    num_classes: int = 1000
    dropout: float = 0.0
    attention_impl: str = "xla"
    norm_impl: str = "xla"        # the blocks' and ln_f's LayerNorm
    remat: bool = False
    dtype: str = "float32"

    @property
    def n_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is no multiple "
                             f"of patch_size {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2

    def block_cfg(self) -> tlm.TransformerLMConfig:
        return tlm.TransformerLMConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_layers=self.n_layers,
            ff_dim=self.ff_dim, dropout=self.dropout, activation="gelu",
            causal=False, attention_impl=self.attention_impl,
            norm_impl=self.norm_impl, remat=self.remat, dtype=self.dtype)


def vit_b16_config(**kw) -> ViTConfig:
    return ViTConfig(**kw)


class ViT(nn.Module):
    """images [B, H, W, 3] (NHWC) → logits fp32 [B, num_classes].
    Parameters are allocated on `device` (None = cuda:0) in fp32."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        bc = cfg.block_cfg()
        p, d = cfg.patch_size, cfg.d_model
        self.patch_embed = nn.Conv2d(3, d, p, stride=p, device=dev)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=dev))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, cfg.n_patches + 1, d, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", tlm.Block(bc, dev))
        self.ln_f = tlm._norm(bc, dev)
        self.head = tlm.Dense(d, cfg.num_classes, bc.compute_dtype, dev)

    @property
    def blocks(self) -> list[tlm.Block]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ViT":
        """flax's initializers: lecun-normal (truncated) patch kernel
        over its fan-in kh*kw*3 and head, zero biases and class token,
        normal(0.02) positions, the blocks as the LM's."""
        for name, p in self.named_parameters():
            if name == "patch_embed.weight":
                std = math.sqrt(1.0 / (p[0].numel())) / .87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name == "pos_embedding":
                p.normal_(0.0, 0.02, generator=generator)
            elif name in ("cls_token", "patch_embed.bias"):
                p.zero_()
            else:
                tlm.init_lm_param(name, p, generator)
        return self

    def forward(self, images, deterministic: bool = True,
                generator: torch.Generator | None = None):
        c = self.cfg
        dt = c.block_cfg().compute_dtype
        x = torch.as_tensor(images, device=self.device).to(dt)
        x = x.permute(0, 3, 1, 2)   # NHWC memory as a NCHW view
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.conv2d(x, self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=c.patch_size)
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)            # [B, n_patches, d]
        cls = self.cls_token.to(dt).expand(B, 1, c.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        drop = tlm.dropout_fn(c.block_cfg(), deterministic, generator)
        x = drop(x)
        policy = "full" if c.remat else "none"
        for block in self.blocks:
            x = apply_remat(block, policy)(x, None, drop)
        x = self.ln_f(x)
        return self.head(x[:, 0]).float()


def params_from_jax(tree: dict, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """The flax ViT's param tree (numpy arrays) as this module's state
    dict: the patch kernel [kh, kw, 3, d] becomes [d, 3, kh, kw]; the
    blocks, `ln_f`, the head and the token and position tables map as
    `transformer_lm.params_from_jax` maps them."""
    rest = {k: v for k, v in tree.items() if k != "patch_embed"}
    sd = tlm.params_from_jax(rest, cfg.block_cfg())
    pe = tree["patch_embed"]
    sd["patch_embed.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(pe["kernel"], np.float32).transpose(3, 2, 0, 1)))
    sd["patch_embed.bias"] = torch.from_numpy(
        np.asarray(pe["bias"], np.float32).copy())
    return sd
