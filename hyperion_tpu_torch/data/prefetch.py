"""Bounded background prefetch — host batch assembly off the step loop;
`hyperion_tpu/data/prefetch.py`, host-only, copied.

The step loop's input cost is host work: `ShardedBatches.host_epoch`
fancy-indexes the epoch permutation and pins each batch's rows. Done
inline, it sits on the critical path between two steps' launches.
`Prefetcher` moves that work onto one daemon thread ahead of the
consumer, bounded by `depth` in-flight batches. The copy to the card
stays with the consumer (`ShardedBatches.to_device`): queued from
pinned memory on the consumer's own stream, it is ordered before the
step that reads it with no cross-stream event, and the pinned block
is not reused before the copy has run (torch's host allocator records
the copy's stream).

Contracts, in order of importance:

1. **Semantics-neutral.** The wrapper never reorders, drops, or
   duplicates: it forwards the wrapped iterator's items verbatim, so a
   prefetched epoch is batch-for-batch identical to the sync path.
   `depth <= 0` doesn't even start a thread: the consumer pulls the
   underlying iterator directly (still timed).
2. **Chaos-aware.** An exception in the worker (a `fault_point
   ("data_iter")` injection, a real storage fault mid-stream) is
   captured and re-raised in the CONSUMER thread at the point the
   failed batch would have arrived — after the batches already queued,
   never silently swallowed with the worker dying alone.
3. **Clean drain.** `close()` (idempotent, also the context-manager
   exit) stops the worker even when it is blocked on a full queue,
   discards queued batches, and joins the thread — a preemption or
   health-abort that breaks out of the step loop mid-epoch leaves no
   thread assembling batches nobody will train on, and the
   stop-before-step boundary stays exact.

`wait_s` accumulates the time the consumer spent blocked waiting for a
batch — the data-starved fraction of the step loop. The trainers read
it per epoch into the `input_wait_s` / `input_wait_frac` gauges
(`obs.registry.observe_input_wait`).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator

DEFAULT_DEPTH = 2

# distinguishable end-of-stream marker (None is a legal item)
_SENTINEL = object()


class Prefetcher:
    """Iterate `iterable` with up to `depth` items assembled ahead.

    One worker thread is enough: batch assembly is numpy fancy-indexing
    and pinning (both release the GIL for their copies), and a single
    producer keeps ordering trivially identical to the sync path.
    """

    def __init__(self, iterable: Iterable[Any], depth: int = DEFAULT_DEPTH):
        self.depth = int(depth)
        self.wait_s = 0.0  # cumulative consumer-side blocked time
        self._it = iter(iterable)
        self._thread: threading.Thread | None = None
        self._q: queue.Queue | None = None
        if self.depth <= 0:
            return  # sync passthrough: no thread, no queue
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._work, name="hyperion-prefetch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ worker

    def _put(self, item: Any) -> bool:
        """Bounded put that stays interruptible: a worker blocked on a
        full queue must notice close() within one poll interval."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        try:
            for item in self._it:
                if not self._put(item):
                    return  # closed mid-epoch: drop the rest
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            self._err = e
        # end-of-stream (or error) marker; close() may already have won
        self._put(_SENTINEL)

    # ---------------------------------------------------------- consumer

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        if self._q is None:  # sync path: pull directly, still timed
            try:
                return next(self._it)
            finally:
                self.wait_s += time.perf_counter() - t0
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is _SENTINEL:
            self._thread.join()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    # ----------------------------------------------------------- cleanup

    def close(self) -> None:
        """Stop the worker and drop queued batches. Safe to call from
        any exit path, any number of times; never raises."""
        if self._thread is None:
            return
        self._stop.set()
        # drain so a put() blocked on a full queue can observe the stop
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
