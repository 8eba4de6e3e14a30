"""Timing on the card — `hyperion_tpu/utils/timing.py` in PyTorch.

PyTorch returns before the card finishes, so a host clock stopped
without a fence measures the enqueue. Two tools, as in the reference:

1. `host_fence` / `sync`: wait for the work. `host_fence(tree)` reads a
   scalar sum of every tensor in `tree` back to the host (a copy the
   host must wait for) and returns it; `sync()` is
   `torch.cuda.synchronize()` on the card and nothing on the CPU.
   `time_fn` times per-call latency on the host clock, fenced each call:
   the host's dispatch is part of that number.
2. `time_chained`: the reference's two-point method
   (`utils/timing.py:194` there). Chains of k1 and k2 data-dependent
   iterations (with `n_thread`, each iteration's first outputs are the
   next one's first arguments) run between CUDA events; the slope
   (t2 - t1) / (k2 - k1) is the per-iteration time with the fixed
   overhead taken out. With `graph=True` each chain is captured once
   into a CUDA graph and replayed between the events, so the host's
   dispatch of the iterations is out of the number too (the
   reference's chain runs inside one jit for the same reason). On the
   CPU the chains run on the wall clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _on_cuda(tree: Any) -> bool:
    return any(t.is_cuda for t in _tensors(tree))


def host_fence(tree: Any = None) -> float:
    """Read back a scalar that consumes every element of every tensor in
    `tree` (the host waits for all the work feeding them) and return
    it. With no tree, `sync()` and 0.0."""
    if tree is None:
        sync()
        return 0.0
    total = 0.0
    for t in _tensors(tree):
        if t.numel():
            total += float(t.detach().float().sum())
    return total


def sync(tree: Any = None) -> None:
    """Wait for `tree` (or all work on the card) to finish."""
    if tree is not None:
        host_fence(tree)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _wait(tree: Any) -> None:
    if _on_cuda(tree):
        torch.cuda.synchronize()


@dataclasses.dataclass
class TimingResult:
    mean_ms: float
    std_ms: float
    min_ms: float
    median_ms: float
    iters: int
    times_ms: list[float]

    def throughput(self, items_per_call: int) -> float:
        """items/s at the mean latency."""
        return items_per_call / (self.mean_ms / 1e3)


def time_fn(fn: Callable[..., Any], *args: Any, warmup: int = 3,
            iters: int = 20, **kwargs: Any) -> TimingResult:
    """Per-call latency on the host clock, the card synchronised after
    each call (so the host's dispatch is part of the number)."""
    for _ in range(warmup):
        _wait(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait(out)
        times.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(times)
    return TimingResult(mean_ms=float(arr.mean()), std_ms=float(arr.std()),
                        min_ms=float(arr.min()),
                        median_ms=float(np.median(arr)), iters=iters,
                        times_ms=times)


@dataclasses.dataclass
class ChainedTimingResult:
    """Per-iteration time from two chain lengths (k1 < k2): `per_iter_ms`
    the slope, `amortized_ms` t2 / k2, `overhead_ms` the fixed cost, and
    `probe` a scalar sum of the final carry (check it is finite)."""

    per_iter_ms: float
    amortized_ms: float
    overhead_ms: float
    k1: int
    k2: int
    t1_ms: float
    t2_ms: float
    probe: float

    def throughput(self, items_per_call: int) -> float:
        return items_per_call / (self.per_iter_ms / 1e3)


def _run_chain(fn, args: tuple, length: int, n_thread: int):
    cur = tuple(args)
    out = None
    for _ in range(length):
        out = fn(*cur)
        if n_thread:
            head = out if n_thread > 1 else (out,)
            cur = tuple(head[:n_thread]) + cur[n_thread:]
    return cur[:n_thread] if n_thread else out


class _Chain:
    """One chain of `length` iterations, ready to time: on the card
    either eager between CUDA events or captured once into a CUDA graph
    (`graph`) and replayed between them; on the CPU eager on the wall
    clock."""

    def __init__(self, fn, args, length, n_thread, cuda: bool, graph: bool):
        self.fn, self.args, self.length = fn, args, length
        self.n_thread, self.cuda = n_thread, cuda
        self.graph = None
        self.result = _run_chain(fn, args, length, n_thread)  # warm
        if cuda:
            torch.cuda.synchronize()
        if cuda and graph:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _run_chain(fn, args, 1, n_thread)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                self.result = _run_chain(fn, args, length, n_thread)
            self.graph.replay()
            torch.cuda.synchronize()

    def seconds(self) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            self.result = _run_chain(self.fn, self.args, self.length,
                                     self.n_thread)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if self.graph is not None:
            self.graph.replay()
        else:
            self.result = _run_chain(self.fn, self.args, self.length,
                                     self.n_thread)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3


def time_chained(fn: Callable[..., Any], *args: Any, k1: int = 8,
                 k2: int = 24, reps: int = 3, n_thread: int = 0,
                 min_window_s: float = 0.01, max_k2: int = 1024,
                 graph: bool = False) -> ChainedTimingResult:
    """Sustained per-iteration time of `fn(*args)` from two chain
    lengths, the best of `reps` runs each. The lengths grow until t2 -
    t1 exceeds `min_window_s` (so timer resolution cannot swamp a small
    op), never past `max_k2`. `graph=True` replays each chain as one
    CUDA graph on the card (a failed capture raises)."""
    if not 0 < k1 < k2:
        raise ValueError(f"need 0 < k1 < k2, got {k1=} {k2=}")
    cuda = _on_cuda(args)

    def measure(k1: int, k2: int) -> tuple[float, float, float]:
        c1 = _Chain(fn, args, k1, n_thread, cuda, graph)
        t1 = min(c1.seconds() for _ in range(reps))
        del c1
        c2 = _Chain(fn, args, k2, n_thread, cuda, graph)
        t2 = min(c2.seconds() for _ in range(reps))
        probe = host_fence(c2.result)
        return t1, t2, probe

    t1, t2, probe = measure(k1, k2)
    while (t2 - t1) < min_window_s and k2 < max_k2:
        window = max(t2 - t1, 1e-5)
        factor = min(max_k2 // k2, max(2, int(min_window_s / window) + 1))
        if factor < 2:
            break
        k1, k2 = k1 * factor, k2 * factor
        t1, t2, probe = measure(k1, k2)
    slope = (t2 - t1) / (k2 - k1)
    if slope <= 0:  # noise swamped the difference: the amortized time
        slope = t2 / k2
    return ChainedTimingResult(
        per_iter_ms=slope * 1e3, amortized_ms=t2 / k2 * 1e3,
        overhead_ms=max(0.0, t1 - k1 * slope) * 1e3, k1=k1, k2=k2,
        t1_ms=t1 * 1e3, t2_ms=t2 * 1e3, probe=probe)
