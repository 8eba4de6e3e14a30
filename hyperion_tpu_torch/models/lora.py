"""LoRA — low-rank adapters, `hyperion_tpu/models/lora.py` in PyTorch.

The reference's Llama job fine-tunes a frozen bf16 Llama-2-7B with
adapters of rank 16, alpha 32 on the q/k/v/o projections (peft's
`LoraConfig`). As in the reference, an adapter is a pair (A, B) with
A ~ He-uniform and B = 0, so training starts at the base model exactly;
the optimizer, and its state, see only the adapters. peft's
`lora_dropout` has no counterpart, as in the reference.

The adapter tree is a flat dict keyed by the JAX kernel path
(`"layer_0/attn/q_proj/kernel"`), each value `{"a": [in, r], "b": [r,
out]}`: the port's projections are 2-D, so a factor whose JAX shape has
head dims is stored flattened. `lora_params_to_jax` /
`lora_params_from_jax` map it to and from the JAX adapter tree
(`{.../q_proj/kernel: {a: [d, r], b: [r, H, Dh]}, .../o_proj/kernel:
{a: [H, Dh, r], b: [r, d]}}`), the layout the JAX trainer exports.

Two formulations, one adapter layout, as in the reference:

  * weight-delta (`apply_lora` / `merge_lora`): W + scale * A @ B,
    computed on JAX-layout trees — the merged export;
  * activation side-path (`LoraDense`): y = x @ W + scale * (x @ A) @ B
    inside the projection, the factors cast to the compute dtype at
    each use, in the reference's bf16 order (`LoraDenseGeneral`,
    `:170-234`). The effective weight never exists; this is the
    training path.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0
    # (regex over the "/"-joined JAX param path, factorization mode):
    #   in_first  kernel [in, *out]  -> a [in, r],   b [r, *out]   (q/k/v)
    #   out_last  kernel [*in, out]  -> a [*in, r],  b [r, out]    (o_proj)
    targets: tuple[tuple[str, str], ...] = (
        (r"(?:.*/)?(q_proj|k_proj|v_proj)/kernel$", "in_first"),
        (r"(?:.*/)?o_proj/kernel$", "out_last"),
    )

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _target_mode(path: str, cfg: LoraConfig) -> str | None:
    for pattern, mode in cfg.targets:
        if re.fullmatch(pattern, path):
            return mode
    return None


def _jax_shapes(mode: str, shape: tuple, rank: int) -> tuple[tuple, tuple]:
    """(a, b) shapes in the JAX layout for a kernel of `shape`."""
    if mode == "in_first":
        return (shape[0], rank), (rank, *shape[1:])
    if mode == "out_last":
        return (*shape[:-1], rank), (rank, shape[-1])
    raise ValueError(f"unknown LoRA target mode {mode!r}")


def init_lora_params(generator: torch.Generator,
                     kernel_shapes: dict[str, tuple], cfg: LoraConfig
                     ) -> dict[str, dict[str, torch.Tensor]]:
    """Adapters for every targeted kernel of `kernel_shapes` (JAX path →
    JAX kernel shape, e.g. `models.llama.jax_kernel_shapes`), drawn in
    sorted path order from `generator`, fp32 on its device: A
    He-uniform over its fan-in (the flattened input width, as flax's
    `he_uniform` counts it for both modes), B zeros. Size rank * (in +
    out) per target, whatever the mode."""
    lora: dict[str, dict[str, torch.Tensor]] = {}
    dev = generator.device
    for path in sorted(kernel_shapes):
        mode = _target_mode(path, cfg)
        if mode is None:
            continue
        a_shape, b_shape = _jax_shapes(mode, tuple(kernel_shapes[path]),
                                       cfg.rank)
        fan_in = math.prod(a_shape[:-1])
        limit = math.sqrt(6.0 / fan_in)
        a = torch.empty(fan_in, cfg.rank, device=dev).uniform_(
            -limit, limit, generator=generator)
        b = torch.zeros(cfg.rank, math.prod(b_shape[1:]), device=dev)
        lora[path] = {"a": a, "b": b}
    if not lora:
        raise ValueError(f"no params matched LoRA targets {cfg.targets}")
    return lora


def lora_params_to_jax(lora: dict[str, dict[str, torch.Tensor]],
                       kernel_shapes: dict[str, tuple], cfg: LoraConfig
                       ) -> dict:
    """The JAX adapter tree (nested, fp32 numpy) of a flat adapter dict:
    each factor reshaped to its JAX layout."""
    tree: dict = {}
    for path, ab in lora.items():
        mode = _target_mode(path, cfg)
        a_shape, b_shape = _jax_shapes(mode, tuple(kernel_shapes[path]),
                                       cfg.rank)
        node = tree
        for key in path.split("/"):
            node = node.setdefault(key, {})
        for name, shape in (("a", a_shape), ("b", b_shape)):
            node[name] = np.ascontiguousarray(
                ab[name].detach().float().cpu().numpy().reshape(shape))
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def lora_params_from_jax(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """A JAX adapter tree (numpy leaves, as `jax.device_get` or
    `checkpoint.io.load_gathered` gives it) → the flat adapter dict,
    fp32 on the CPU: a [in, r], b [r, out]."""
    lora: dict[str, dict[str, torch.Tensor]] = {}
    for key, leaf in _flatten(tree).items():
        path, name = key.rsplit("/", 1)
        x = np.asarray(leaf, dtype=np.float32)
        x = x.reshape(-1, x.shape[-1]) if name == "a" \
            else x.reshape(x.shape[0], -1)
        lora.setdefault(path, {})[name] = torch.from_numpy(x.copy())
    return lora


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.array(x))


def apply_lora(base_params: dict, lora_params: dict, cfg: LoraConfig) -> dict:
    """Effective params: base + scale * A @ B on the targeted kernels,
    over JAX-layout trees (numpy or torch leaves): `tensordot(a, b)` in
    the adapters' dtype, cast to the kernel's, added — the reference's
    arithmetic. Leaves come back as detached torch tensors."""
    flat_lora = _flatten(lora_params)
    tree: dict = {}
    for path, w in _flatten(base_params).items():
        w = _tensor(w)
        if f"{path}/a" in flat_lora:
            delta = torch.tensordot(_tensor(flat_lora[f"{path}/a"]),
                                    _tensor(flat_lora[f"{path}/b"]),
                                    dims=1) * cfg.scale
            w = w + delta.to(w.dtype)
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = w
    return tree


def merge_lora(base_params: dict, lora_params: dict, cfg: LoraConfig) -> dict:
    """Bake the adapters into the base weights (peft `merge_and_unload`)
    for export and serving."""
    return apply_lora(base_params, lora_params, cfg)


def target_module_names(lora_params: dict) -> tuple[str, ...]:
    """Module names (e.g. 'q_proj') that carry adapters, from the flat
    adapter dict itself: the one source of a model config's
    `lora_targets`."""
    names = set()
    for path in lora_params:
        parts = path.split("/")  # ".../<module>/kernel"
        if len(parts) >= 2 and parts[-1] == "kernel":
            names.add(parts[-2])
    return tuple(sorted(names))


def count_params(tree) -> int:
    """Elements over every leaf of a (nested) dict of arrays or tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(np.prod(tuple(tree.shape)))


def trainable_fraction(base_params, lora_params) -> float:
    """The 'trainable params: X%' line peft prints."""
    return count_params(lora_params) / max(count_params(base_params), 1)


class LoraDense(nn.Module):
    """A bias-free projection, weight [out, in] in the compute dtype,
    with the activation side-path

        y = x @ W  +  scale * (x @ A) @ B

    A [in, r] and B [r, out] are parameters in their own dtype (the
    policy's param dtype), cast to the compute dtype at each use, and
    the scale multiplies the rank-r product in that dtype, as the
    reference's `LoraDenseGeneral` rounds it."""

    def __init__(self, d_in: int, d_out: int, rank: int, scale: float,
                 dtype: torch.dtype, device):
        super().__init__()
        self.scale = scale
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=dtype, device=device),
            requires_grad=False)
        self.lora_a = nn.Parameter(torch.zeros(d_in, rank, device=device))
        self.lora_b = nn.Parameter(torch.zeros(rank, d_out, device=device))

    def forward(self, x):
        xc = x.to(self.dtype)
        y = F.linear(xc, self.weight.to(self.dtype))
        xa = torch.matmul(xc, self.lora_a.to(self.dtype))
        return y + self.scale * torch.matmul(xa, self.lora_b.to(self.dtype))
