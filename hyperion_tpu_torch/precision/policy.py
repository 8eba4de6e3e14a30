"""Mixed-precision policies — `hyperion_tpu/precision/policy.py:27-67`
with torch dtypes.

A policy names three dtypes: the parameters' (the fp32 master weights
under "bf16"), the compute dtype the model casts them to at use, and the
reduction dtype. The port applies the compute dtype by explicit casts in
each module, as the flax modules do with `dtype=compute_dtype`, not by
`torch.autocast`: every kernel then sees the dtypes the JAX kernel sees.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    reduce_dtype: torch.dtype


POLICIES = {
    # full precision
    "fp32": Policy("fp32", torch.float32, torch.float32, torch.float32),
    # fp32 master params, bf16 compute (no loss scaler needed)
    "bf16": Policy("bf16", torch.float32, torch.bfloat16, torch.float32),
    # bf16 everywhere
    "bf16_full": Policy("bf16_full", torch.bfloat16, torch.bfloat16,
                        torch.bfloat16),
}


def get_policy(name: str | Policy) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; have "
                         f"{sorted(POLICIES)}") from None
