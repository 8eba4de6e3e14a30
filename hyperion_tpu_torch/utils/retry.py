"""Retry with exponential backoff — the IO-resilience primitive.

Preemptible-capacity runs live on shared storage whose failures are
overwhelmingly *transient* (an NFS server failing over, a GCS 503, a
flapping tunnel mid-read); the reference answered those with a crashed
epoch. Here every checkpoint save/restore and dataset read routes
through `retry_call`: exponential backoff + deterministic jitter +
a wall-clock deadline, retrying only errors classified transient —
a `ValueError` from a genuinely corrupt file must surface immediately,
not after 30 s of futile retries (the verified-checkpoint walk-back in
`checkpoint/integrity.py` is the reaction to *permanent* damage).

`fault_point(tag)` is the chaos seam: production IO paths call it where
a real storage fault would land, and it is a no-op unless the fault
injector is registered (`testing/chaos.py` does, for `io_fail@p=X`
plans) — zero overhead and zero test-code imports in the hot path.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable

# Errors that plausibly heal on retry. TimeoutError/ConnectionError are
# OSError subclasses, listed for readers; Interrupted/BlockingIOError
# ride along. Everything else (ValueError, KeyError, orbax's own
# validation errors, ...) is permanent: the bytes are wrong, not late.
TRANSIENT_ERRORS: tuple[type[BaseException], ...] = (
    OSError,
    TimeoutError,
    ConnectionError,
)


def is_transient(exc: BaseException) -> bool:
    """Default transient-vs-permanent classification."""
    return isinstance(exc, TRANSIENT_ERRORS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape: delay_n = min(base * 2^n, max) * jitter, stopping
    after `tries` attempts or when the next sleep would cross
    `deadline_s` of total elapsed wall time (whichever first)."""

    tries: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 10.0
    deadline_s: float = 120.0
    jitter: float = 0.25  # ±fraction of the delay

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        if self.jitter:
            d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


#: conservative defaults for checkpoint/dataset IO: three attempts,
#: sub-second backoff — a real outage should fail over to the caller's
#: own recovery (walk-back, supervisor restart) within seconds, not
#: block a preemption grace window.
IO_RETRY = RetryPolicy(tries=3, base_delay_s=0.05, max_delay_s=2.0,
                       deadline_s=60.0)


def retry_call(
    fn: Callable,
    *,
    policy: RetryPolicy = IO_RETRY,
    classify: Callable[[BaseException], bool] = is_transient,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    seed: int = 0,
):
    """Call `fn()` with retry-on-transient. `fn` receives no arguments —
    close over state. `on_retry(attempt, exc, delay_s)` observes each
    retry (trace events, prints). The LAST exception propagates when
    attempts or the deadline run out; permanent errors propagate
    immediately. Jitter is seeded (deterministic under test)."""
    rng = random.Random(seed)
    t0 = clock()
    last: BaseException | None = None
    for attempt in range(max(1, policy.tries)):
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — reclassified below
            if not classify(exc):
                raise
            last = exc
            delay = policy.delay(attempt, rng)
            out_of_tries = attempt + 1 >= max(1, policy.tries)
            past_deadline = clock() - t0 + delay > policy.deadline_s
            if out_of_tries or past_deadline:
                raise
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    raise last  # pragma: no cover — loop always returns or raises


# --------------------------------------------------------- chaos seam

_fault_injector: Callable[[str], None] | None = None


def set_fault_injector(fn: Callable[[str], None] | None) -> None:
    """Register (or clear, with None) the process-wide fault injector.
    Only `testing/chaos.py` should call this; production code never
    does."""
    global _fault_injector
    _fault_injector = fn


def fault_point(tag: str) -> None:
    """A named site where a storage fault could land (ckpt_save /
    ckpt_restore / data_read / data_iter). No-op unless an injector is
    registered."""
    if _fault_injector is not None:
        _fault_injector(tag)
