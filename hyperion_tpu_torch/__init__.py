"""hyperion_tpu_torch — the PyTorch/CUDA port of `hyperion_tpu`, for
one NVIDIA H100.

The JAX package `hyperion_tpu/` is the reference: every module here
keeps its counterpart's name and layout, and the tests hold each one
against it on the CPU. This package imports torch, numpy and the
standard library only — never jax, and nothing of the JAX package.

Devices are explicit. Every entry point takes `device=None`, which
means `cuda:0`; with no CUDA device that raises and says to pass
`device="cpu"` — nothing falls back to the CPU quietly. On a CUDA
tensor each kernel wrapper (`ops/flash_attention.py`, `ops/fused_ce.py`,
`ops/fused_norm.py`, `ops/paged_attention.py`, `ops/int8_matmul.py`)
launches its
hand-written Hopper kernel; on a CPU tensor it runs the kernel's plain
PyTorch version.

Importing the package builds nothing: the kernels compile with `nvcc`
on their first launch (`ops/build.py`).
"""

from __future__ import annotations

import importlib

_LAZY = {
    "fused_rmsnorm": "hyperion_tpu_torch.ops.fused_norm",
    "paged_attention": "hyperion_tpu_torch.ops.paged_attention",
}


def resolve_device(device=None):
    """`device` as a `torch.device`; None means `cuda:0`. Raises when
    CUDA is asked for (explicitly or by default) and absent."""
    import torch

    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "present; pass device=\"cpu\" to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
