"""Device-memory accounting — `hyperion_tpu/utils/memory.py` over the
CUDA caching allocator.

`device_memory_stats` gives the reference's keys (`bytes_in_use`,
`peak_bytes_in_use`, `bytes_reserved`) from `torch.cuda.memory_stats`.
The CPU has no device allocator: the stats are empty there, as the
reference's are on backends without them, and every reader degrades to
0.
"""

from __future__ import annotations


def device_memory_stats(device=None) -> dict:
    import torch

    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0))}


def live_bytes_in_use(device=None) -> int:
    return int(device_memory_stats(device).get("bytes_in_use", 0))


def peak_bytes_in_use(device=None) -> int:
    s = device_memory_stats(device)
    return int(s.get("peak_bytes_in_use", s.get("bytes_in_use", 0)))
