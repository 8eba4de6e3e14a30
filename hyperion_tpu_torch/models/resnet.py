"""ResNet-18 and ResNet-50 — `hyperion_tpu/models/resnet.py:33-153`.

`resnet18()` is the `cifar` job's model (CIFAR stem: a 3x3 stride-1
conv, no max-pool; stages of (2, 2, 2, 2) basic blocks at widths 64 to
512; 11.2M parameters); `resnet50()` the bottleneck variant with the
ImageNet stem (7x7 stride-2 conv and a 3x3 stride-2 max-pool). Module
names follow the flax tree (`stem_conv`, `stem_bn`,
`stage{s}_block{b}/{conv1,bn1,conv2,bn2,conv3,bn3,down_conv,down_bn}`,
`fc`); `params_from_jax` / `state_to_jax` convert to and from flax's
layouts (conv kernels HWIO <-> OIHW, `fc` [in, out] <-> [out, in], BN
`scale`/`bias` <-> `weight`/`bias`, `batch_stats` `mean`/`var` <-> the
`running_mean`/`running_var` buffers).

Tensors are NCHW, in `channels_last` memory on the card (`to(memory_
format=torch.channels_last)`): an NHWC batch permuted to NCHW is
already in that layout, so the trainer permutes once on the device and
copies nothing. Parameters stay fp32 and are cast to the compute dtype
at use, as flax's `dtype=` does; the logits are fp32. A float64 model
(`dtype="float64"`, then `.double()`) runs in float64 throughout, its
statistics and logits too: a reference for an fp32 run's gradients.

Three places where a straight translation goes wrong:

  * flax `"SAME"` padding is asymmetric under a stride: the total pad is
    max((out - 1) * s + k - in, 0) with out = ceil(in / s), the odd
    pixel at the end (3x3/s2 on 32 pads 0 before and 1 after; 7x7/s2 on
    224 pads 2 and 3; the max-pool pads -inf 0 and 1). `same_pads`
    computes it from the input size; `nn.Conv2d(padding=1)` would shift
    every strided window by a pixel.
  * flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` is not
    `nn.BatchNorm2d`: its batch statistics are fp32 whatever the compute
    dtype, the variance is E[x^2] - E[x]^2 clipped at 0, the output is
    (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32 cast to the
    compute dtype, and the running averages are 0.9 * running + 0.1 *
    batch with the BIASED batch variance (torch updates `running_var`
    with the unbiased one). `BatchNorm` writes that arithmetic out.
  * the batch statistics are global over the data axis: under `jit`
    the reference's means are global-view (`:12-17` there). Over ranks
    (`set_batch_groups`) each BN all-reduces the per-channel sum and sum
    of squares over the batch axes' groups before it normalises, with a
    differentiable all-reduce whose backward sums the statistics'
    gradients over the ranks (SyncBN, with flax's formula). With no
    groups no collective runs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyperion_tpu_torch import resolve_device

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (2, 2, 2, 2)
    bottleneck: bool = False
    num_classes: int = 10
    width: int = 64
    cifar_stem: bool = True
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def at_least_fp32(dtype: torch.dtype) -> torch.dtype:
    """The statistics' and the logits' dtype: fp32 under bf16 and fp32,
    as flax's; float64 in a float64 model (a reference run)."""
    return torch.promote_types(dtype, torch.float32)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/lax "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    (t, b), (l, r) = (same_pads(x.shape[-2], k, stride),
                      same_pads(x.shape[-1], k, stride))
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


class Conv(nn.Module):
    """flax `nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=False, dtype=...)`: weight [out, in, k, k] fp32, cast to
    the compute dtype at use. Symmetric padding rides the convolution;
    an asymmetric one is an explicit pad first."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))

    def forward(self, x):
        k, s = self.k, self.stride
        pads = same_pads(x.shape[-2], k, s) + same_pads(x.shape[-1], k, s)
        if pads[0] == pads[1] == pads[2] == pads[3]:
            padding = pads[0]
        else:
            x, padding = _pad_same(x, k, s), 0
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=s, padding=padding)


def batch_moments(x: torch.Tensor, groups=()) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """flax `_compute_stats` over N, H, W of an NCHW `x`: the fp32 mean
    and the variance E[x^2] - E[x]^2 clipped at 0, global over the ranks
    of `groups` (each all-reduced in turn, differentiably)."""
    xf = x.to(at_least_fp32(x.dtype))
    dims = (0, 2, 3)
    sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
    n = x.numel() // x.shape[1]
    if groups:
        import torch.distributed as tdist
        from torch.distributed.nn.functional import all_reduce

        for g in groups:
            sums = all_reduce(sums, group=g)
            n *= tdist.get_world_size(g)
    mean, mean2 = sums[0] / n, sums[1] / n
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)` on
    NCHW (see the module docstring). `train` normalises by the batch's
    statistics and updates the running ones; eval by the running
    ones."""

    def __init__(self, c: int, dtype: torch.dtype, device,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale  # the block's last BN starts at 0
        self.weight = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))
        self.groups: list = []

    def forward(self, x, train: bool):
        if train:
            mean, var = batch_moments(x, self.groups)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.mul_(m).add_(mean.detach() * (1 - m))
                self.running_var.mul_(m).add_(var.detach() * (1 - m))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x.to(mean.dtype) - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, dtype, device)
        self.bn1 = BatchNorm(features, dtype, device)
        self.conv2 = Conv(features, features, 3, 1, dtype, device)
        self.bn2 = BatchNorm(features, dtype, device, zero_scale=True)
        if stride != 1 or cin != features:
            self.down_conv = Conv(cin, features, 1, stride, dtype, device)
            self.down_bn = BatchNorm(features, dtype, device)

    def forward(self, x, train: bool):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = (self.down_bn(self.down_conv(x), train)
                    if hasattr(self, "down_conv") else x)
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        out = features * 4
        self.conv1 = Conv(cin, features, 1, 1, dtype, device)
        self.bn1 = BatchNorm(features, dtype, device)
        self.conv2 = Conv(features, features, 3, stride, dtype, device)
        self.bn2 = BatchNorm(features, dtype, device)
        self.conv3 = Conv(features, out, 1, 1, dtype, device)
        self.bn3 = BatchNorm(out, dtype, device, zero_scale=True)
        if stride != 1 or cin != out:
            self.down_conv = Conv(cin, out, 1, stride, dtype, device)
            self.down_bn = BatchNorm(out, dtype, device)

    def forward(self, x, train: bool):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = (self.down_bn(self.down_conv(x), train)
                    if hasattr(self, "down_conv") else x)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """images [B, 3, H, W] (NCHW) → logits fp32 [B, num_classes].

    Parameters are allocated on `device` (None = cuda:0) in fp32 and
    filled by `init_params(generator)` or `load_state_dict`
    (`params_from_jax`). `train` picks batch or running statistics."""

    def __init__(self, cfg: ResNetConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        dt = cfg.compute_dtype
        w = cfg.width
        if cfg.cifar_stem:
            self.stem_conv = Conv(3, w, 3, 1, dt, dev)
        else:
            self.stem_conv = Conv(3, w, 7, 2, dt, dev)
        self.stem_bn = BatchNorm(w, dt, dev)
        block_cls = BottleneckBlock if cfg.bottleneck else BasicBlock
        cin = w
        self._block_names = []
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                feats = w * 2 ** stage
                name = f"stage{stage}_block{b}"
                self.add_module(name, block_cls(cin, feats, stride, dt, dev))
                self._block_names.append(name)
                cin = feats * block_cls.expansion
        self.fc = nn.Linear(cin, cfg.num_classes, device=dev)

    @property
    def blocks(self) -> list[nn.Module]:
        return [getattr(self, n) for n in self._block_names]

    def set_batch_groups(self, groups) -> None:
        """Make every BatchNorm's statistics global over `groups` (the
        batch axes' process groups; empty for one rank)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.groups = list(groups)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ResNet":
        """The flax initializers, drawn from `generator` in parameter
        order: conv kernels variance_scaling(2.0, "fan_out", "normal"),
        the `fc` kernel lecun-normal (truncated) with a zero bias, BN
        scales 1 (0 for each block's last) and biases 0, running mean 0
        and variance 1."""
        for mod in self.modules():
            if isinstance(mod, Conv):
                o, _, kh, kw = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * o)),
                                   generator=generator)
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        std = math.sqrt(1.0 / self.fc.weight.shape[1]) / .87962566103423978
        nn.init.trunc_normal_(self.fc.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.fc.bias.zero_()
        return self

    def forward(self, images, train: bool = False):
        c = self.cfg
        x = images.to(self.device)
        if x.device.type == "cpu":
            # torch's multi-threaded CPU convolution backward crashes on
            # some channels_last inputs (a segfault at batch 4, width 8,
            # 16x16); the plain path runs NCHW-contiguous
            x = x.contiguous()
        x = self.stem_conv(x)
        x = F.relu(self.stem_bn(x, train))
        if not c.cifar_stem:
            x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean((2, 3))
        dt = c.compute_dtype
        return F.linear(x, self.fc.weight.to(dt),
                        self.fc.bias.to(dt)).to(at_least_fp32(dt))


def resnet18(num_classes: int = 10, cifar_stem: bool = True,
             dtype: str = "float32", *, device=None, **kw) -> ResNet:
    """The reference's `resnet18` on `device`; `kw` overrides any other
    config field (a narrow `width` in tests)."""
    return ResNet(ResNetConfig((2, 2, 2, 2), False, num_classes,
                               cifar_stem=cifar_stem, dtype=dtype, **kw),
                  device=device)


def resnet50(num_classes: int = 1000, cifar_stem: bool = False,
             dtype: str = "float32", *, device=None, **kw) -> ResNet:
    return ResNet(ResNetConfig((3, 4, 6, 3), True, num_classes,
                               cifar_stem=cifar_stem, dtype=dtype, **kw),
                  device=device)


# --- weight interchange with the JAX package -------------------------


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


_FROM_STATS = {"mean": "running_mean", "var": "running_var"}
_TO_STATS = {v: k for k, v in _FROM_STATS.items()}


def params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The flax variables `{"params": ..., "batch_stats": ...}` (numpy
    arrays; `batch_stats` may be absent, as in a params-only export) as
    this module's `state_dict`, fp32 on the CPU."""
    sd = {}
    for path, a in _flatten(variables.get("params", {})).items():
        *mods, leaf = path
        a = np.array(a, dtype=np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join([*mods, leaf])] = torch.from_numpy(
            np.ascontiguousarray(a))
    for path, a in _flatten(variables.get("batch_stats", {})).items():
        *mods, leaf = path
        sd[".".join([*mods, _FROM_STATS[leaf]])] = torch.from_numpy(
            np.array(a, dtype=np.float32))
    return sd


def state_to_jax(named: dict[str, torch.Tensor]) -> dict:
    """Tensors named as this module's `state_dict` (or its parameters'
    gradients) → `{"params": ..., "batch_stats": ...}` in the flax
    layout, fp32 numpy (`batch_stats` only when buffers are given)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in named.items():
        *mods, leaf = name.split(".")
        a = t.detach().float().cpu().numpy()
        section = "params"
        if leaf in _TO_STATS:
            section, leaf = "batch_stats", _TO_STATS[leaf]
        elif leaf == "weight" and a.ndim == 4:
            a, leaf = a.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight" and a.ndim == 2:
            a, leaf = a.T, "kernel"
        elif leaf == "weight":
            leaf = "scale"
        node = out[section]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
