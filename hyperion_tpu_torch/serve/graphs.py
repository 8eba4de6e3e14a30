"""The serve engine's compile tier: one CUDA graph per device surface
and shape.

The JAX engine runs each device surface — the decode tick, one prefill
per bucket, the spec tick, the chunk window and the COW block copy — as
one XLA executable per shape, built at warmup, counted by
`compile_stats()` and pinned by `obs/ledger.py`. On the card the
counterpart is a CUDA graph per (surface, shape), captured at warmup:
a tick is then one graph launch instead of hundreds of kernel launches
from the host, and a shape nobody warmed captures a new graph, which
the ledger sees grow exactly as it sees a recompile.

`GraphTier.run(surface, body, inputs)` is the one way the engine
touches the device surfaces:

  * On the card, the first call at a shape runs `body` once eagerly on
    zero inputs (that builds the kernels and settles cuBLAS outside any
    capture; zero block tables route every write to the null block) and
    then captures it into a `torch.cuda.CUDAGraph`. All graphs share one
    memory pool, since they never run at once. Every call copies the
    host inputs into the graph's static device buffers from pinned
    staging and replays; the caller reads the graph's static outputs
    before it replays another graph. A failed capture raises, naming
    the surface and shape: nothing falls back to an eager call.
  * On the CPU there are no graphs: `body` runs eagerly on the inputs,
    and the tier counts the distinct (surface, shape) keys it has run,
    so the ledger's invariant holds and is testable there too.

Launch accounting: the kernel wrappers count launches in Python
(`fn.launches += 1`), so a capture counts launches that never ran and
a replay counts none. The tier takes back what the capture counted,
keeps it as the graph's launches, and adds them at every replay: a
wrapper's `launches` still means "kernels the card ran".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

# surface -> the `compile_stats()` key the JAX engine reports it under
STAT_KEYS = {
    "tick": "tick_executables",
    "prefill": "prefill_executables",
    "copy": "copy_executables",
    "spec_tick": "spec_tick_executables",
    "chunk": "chunk_executables",
}


def kernel_counters() -> tuple:
    """The kernel wrappers the cached Llama forward launches, each
    counting its launches in `launches`."""
    from hyperion_tpu_torch.ops import fused_norm, paged_attention

    return (paged_attention.paged_attention, fused_norm.fused_rmsnorm)


@dataclasses.dataclass
class Graph:
    """One captured surface: its static inputs and their pinned staging,
    its static outputs, the launches one replay makes, and an event that
    marks when the last upload left the staging."""

    graph: torch.cuda.CUDAGraph
    inputs: dict[str, torch.Tensor]
    staging: dict[str, torch.Tensor]
    outputs: object
    launches: dict
    uploaded: torch.cuda.Event
    capture_s: float


class GraphTier:
    """The graphs (on the card) or the keys run (on the CPU) of one
    engine. `stats()` is `compile_stats()`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.graphs: dict[tuple, Graph] = {}
        self._seen: set[tuple] = set()
        self._pool = None
        self._side: torch.cuda.Stream | None = None
        self.upload_s = 0.0  # cumulative host->device input copy seconds

    @staticmethod
    def key(surface: str, inputs: dict[str, np.ndarray]) -> tuple:
        return (surface, tuple((k, v.shape) for k, v in inputs.items()))

    def stats(self) -> dict[str, int]:
        counts = dict.fromkeys(STAT_KEYS.values(), 0)
        for surface, _ in (self.graphs if self.on_card else self._seen):
            counts[STAT_KEYS[surface]] += 1
        return counts

    def run(self, surface: str, body: Callable,
            inputs: dict[str, np.ndarray]):
        """`body(**tensors)` at these inputs' shapes: replayed from its
        graph on the card (captured on first use), eager on the CPU."""
        key = self.key(surface, inputs)
        if not self.on_card:
            self._seen.add(key)
            return body(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in inputs.items()})
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, body, inputs)
        t0 = time.perf_counter()
        g.uploaded.synchronize()  # the last upload has left the staging
        for name, arr in inputs.items():
            np.copyto(g.staging[name].numpy(), arr)
            g.inputs[name].copy_(g.staging[name], non_blocking=True)
        g.uploaded.record()
        self.upload_s += time.perf_counter() - t0
        g.graph.replay()
        for fn, n in g.launches.items():
            fn.launches += n
        return g.outputs

    def _capture(self, key: tuple, body: Callable,
                 inputs: dict[str, np.ndarray]) -> Graph:
        t0 = time.perf_counter()
        dev = self.device
        static = {k: torch.zeros(v.shape, device=dev,
                                 dtype=torch.from_numpy(v[:0]).dtype)
                  for k, v in inputs.items()}
        staging = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   for k, t in static.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            body(**static)  # eager: kernels built before any capture
        main.wait_stream(self._side)
        counters = kernel_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                outputs = body(**static)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the {key[0]} surface at "
                f"{dict(key[1])} failed: {e}") from e
        launches = {}
        for fn, b in zip(counters, before):
            if fn.launches != b:  # captured, not run: counted per replay
                launches[fn] = fn.launches - b
                fn.launches = b
        return Graph(graph, static, staging, outputs, launches,
                     torch.cuda.Event(), time.perf_counter() - t0)

    def capture_seconds(self) -> dict[str, float]:
        """Seconds each graph took to build (its eager pass included),
        keyed `surface[shape, ...]`."""
        return {f"{s}{[tuple(v) for _, v in shape]}": g.capture_s
                for (s, shape), g in self.graphs.items()}

    def pool_bytes(self) -> int | None:
        """Device bytes the graphs' shared memory pool holds (None before
        the first capture, or where the allocator snapshot does not name
        pools)."""
        if self._pool is None:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == tuple(self._pool):
                total += int(seg["total_size"])
        return total if named else None
