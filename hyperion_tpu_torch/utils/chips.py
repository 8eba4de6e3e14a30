"""Nominal device peaks — `hyperion_tpu/utils/chips.py` for the port's
card.

The numbers are NVIDIA's H100 SXM5 datasheet's dense (no sparsity)
tensor-core peaks, not measurements: the denominators of MFU, and the
plausibility bound above which no measured rate may be published.
`nominal_peak_tflops` returns None for a device it does not tabulate
(the CPU), and `registry.mfu_value` then falls back to a measured host
matmul rate, labelled as such.
"""

from __future__ import annotations

# device name substring (lowercased) -> dense TFLOP/s by operand type,
# from the H100 SXM5 datasheet
_PEAKS: tuple[tuple[str, dict[str, float]], ...] = (
    ("h100 80gb hbm3", {"bfloat16": 989.4, "float16": 989.4,
                        "tf32": 494.7, "float32": 66.9}),
)


def device_kind(device=None) -> str:
    """The device's name: the card's (`torch.cuda.get_device_name`) or
    "cpu"."""
    import torch

    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def nominal_peak_tflops(dtype: str = "bfloat16", device=None) -> float | None:
    """The datasheet's dense peak for `dtype` ("bfloat16", "float16",
    "tf32", "float32") on this device, or None when the device or dtype
    is not tabulated."""
    kind = device_kind(device).lower()
    for sub, peaks in _PEAKS:
        if sub in kind:
            return peaks.get(dtype)
    return None


def mfu(tflops: float, dtype: str = "bfloat16", device=None) -> float | None:
    """Model-FLOPs-utilisation fraction against the nominal peak."""
    peak = nominal_peak_tflops(dtype, device)
    if not peak:
        return None
    return tflops / peak
