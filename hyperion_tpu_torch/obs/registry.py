"""Counters / gauges / histograms with a per-step `snapshot()`.

The host half of `hyperion_tpu/obs/registry.py`: named instruments in
one registry, so every entry point reports the same schema and the
repo's `obs` readers can parse a port run unchanged. Histograms keep a
bounded window (default 8192 observations) plus exact running
count/sum/min/max, so a week-long run cannot grow memory while
percentiles stay meaningful over the recent window.

Every instrument additionally keeps a bounded ring of TIMESTAMPED
samples, so a reader can ask "what happened in the last N seconds"
instead of "since the process started" — `Histogram.windowed`,
`Counter.windowed_delta` and `Gauge.windowed`, rolled up by
`MetricsRegistry.windowed_snapshot`. Appends are O(1) host work, and
all reads copy the ring first (`list(deque)` is atomic under the GIL),
so another thread can snapshot while the owning loop keeps writing.

The device half (device memory, MFU from compiled cost analysis) is
still to port.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Any

_EMA_ALPHA = 0.1
_HIST_WINDOW = 8192


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile of an iterable — the ONE implementation
    both live histograms and the offline reporter use, so snapshots and
    `obs summarize` can never disagree on what p50/p99 means."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    rank = max(0, min(len(xs) - 1, math.ceil(p / 100.0 * len(xs)) - 1))
    return xs[rank]


class Counter:
    __slots__ = ("value", "timed", "_samples", "_clock")

    def __init__(self, clock=time.monotonic):
        self.value = 0.0
        # (t, n) increments — windowed_delta sums the recent ones, so
        # "tokens in the last 60s" (a rate) is answerable without a
        # second counter. Bounded: a window busier than the ring cap
        # drops OLD samples only — `covered_window_s` reports how much
        # of a requested window the ring still covers, and every rate
        # or cross-counter ratio MUST use that as its denominator (a
        # truncated busy counter next to an untruncated rare one would
        # otherwise skew the ratio — the SLO helpers clamp to the
        # common covered span).
        self.timed: collections.deque = collections.deque(maxlen=_HIST_WINDOW)
        self._samples = 0     # lifetime count: tells truncation from youth
        self._clock = clock

    def inc(self, n: float = 1.0) -> None:
        self.value += n
        self.timed.append((self._clock(), n))
        self._samples += 1

    def windowed_delta(self, window_s: float, now: float | None = None,
                       ) -> float:
        """Sum of the RETAINED increments in the last `window_s`
        seconds (an overflowed ring undercounts the window's oldest
        part — pair with `covered_window_s` for honest rates)."""
        now = self._clock() if now is None else now
        cut = now - window_s
        return sum(n for t, n in list(self.timed) if t >= cut)

    def covered_window_s(self, window_s: float,
                         now: float | None = None) -> float:
        """How much of the last `window_s` seconds the ring actually
        covers: the full window when nothing in it was dropped (a
        young or idle counter genuinely saw zero events in the gap —
        that IS coverage), else only the span back to the oldest
        retained sample."""
        now = self._clock() if now is None else now
        items = list(self.timed)
        if not items or self._samples <= len(items) \
                or items[0][0] <= now - window_s:
            return window_s
        return max(0.0, now - items[0][0])


class Gauge:
    __slots__ = ("value", "timed", "_clock")

    def __init__(self, clock=time.monotonic):
        self.value: float | None = None
        self.timed: collections.deque = collections.deque(maxlen=_HIST_WINDOW)
        self._clock = clock

    def set(self, v: float | None) -> None:
        self.value = None if v is None else float(v)
        if self.value is not None:
            self.timed.append((self._clock(), self.value))

    def ema(self, v: float, alpha: float = _EMA_ALPHA) -> None:
        v = float(v)
        self.value = v if self.value is None else (
            alpha * v + (1 - alpha) * self.value
        )
        self.timed.append((self._clock(), self.value))

    def windowed(self, window_s: float, now: float | None = None) -> dict:
        """Envelope of the values set in the last `window_s` seconds."""
        now = self._clock() if now is None else now
        cut = now - window_s
        xs = [v for t, v in list(self.timed) if t >= cut]
        if not xs:
            return {"count": 0}
        return {"count": len(xs), "last": xs[-1],
                "mean": sum(xs) / len(xs), "min": min(xs), "max": max(xs)}


class Histogram:
    __slots__ = ("window", "count", "total", "min", "max", "timed",
                 "_clock")

    def __init__(self, window: int = _HIST_WINDOW, clock=time.monotonic):
        self.window: collections.deque = collections.deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        # (t, v) ring behind `windowed()`: live percentiles over the
        # last N SECONDS (the dashboard/SLO view), next to the
        # last-N-observations window `summary()` keeps serving
        self.timed: collections.deque = collections.deque(maxlen=window)
        self._clock = clock

    def observe(self, v: float) -> None:
        v = float(v)
        self.window.append(v)
        self.timed.append((self._clock(), v))
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained window (exact for
        runs shorter than the window)."""
        return percentile(self.window, p)

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def windowed(self, window_s: float, now: float | None = None) -> dict:
        """`summary()`-shaped roll-up over the observations of the last
        `window_s` seconds — the p99 a dashboard should show for a
        process that has been up for a week."""
        now = self._clock() if now is None else now
        cut = now - window_s
        xs = [v for t, v in list(self.timed) if t >= cut]
        if not xs:
            return {"count": 0}
        return {
            "count": len(xs),
            "mean": sum(xs) / len(xs),
            "min": min(xs),
            "max": max(xs),
            "p50": percentile(xs, 50),
            "p90": percentile(xs, 90),
            "p95": percentile(xs, 95),
            "p99": percentile(xs, 99),
        }


class MetricsRegistry:
    """Get-or-create instruments by name; `snapshot()` is the one wire
    schema every reader (tracer records, `obs summarize`) consumes.
    `clock` is injectable so windowed tests drive fake time through
    every instrument the registry creates."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._labels: dict[str, str] = {}

    @property
    def clock(self):
        """The time source every instrument of this registry stamps with
        (what a reader of its windows must take `now` from)."""
        return self._clock

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters.setdefault(name, Counter(clock=self._clock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges.setdefault(name, Gauge(clock=self._clock))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists.setdefault(name,
                                       Histogram(clock=self._clock))
        return h

    def set_label(self, name: str, value: str) -> None:
        """String annotations riding with the numbers (e.g. which peak
        source an MFU was computed against)."""
        self._labels[name] = str(value)

    def snapshot(self) -> dict:
        # list() copies before iterating: the exposition socket
        # snapshots from its own thread while the owning loop may be
        # get-or-creating instruments
        return {
            "counters": {k: c.value
                         for k, c in list(self._counters.items())},
            "gauges": {k: g.value for k, g in list(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in list(self._hists.items())},
            "labels": dict(self._labels),
        }

    def windowed_snapshot(self, window_s: float,
                          now: float | None = None) -> dict:
        """Last-`window_s`-seconds roll-up of every instrument — the
        `windows` section of the exposition payload (obs/export.py).
        A separate shape on purpose: the lifetime `snapshot()` wire
        schema is pinned by the fixture contract tests and stays
        untouched."""
        now = self._clock() if now is None else now

        def _counter(c: Counter) -> dict:
            # rates over the COVERED span: a ring that wrapped inside
            # the window must not report tokens/window as tokens/s
            span = c.covered_window_s(window_s, now)
            d = c.windowed_delta(window_s, now)
            return {"delta": d, "covered_s": round(span, 3),
                    "per_s": round(d / span, 6) if span > 0 else 0.0}

        return {
            "window_s": window_s,
            "counters": {k: _counter(c)
                         for k, c in list(self._counters.items())},
            "gauges": {k: g.windowed(window_s, now)
                       for k, g in list(self._gauges.items())},
            "histograms": {k: h.windowed(window_s, now)
                           for k, h in list(self._hists.items())},
        }
