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

The built-ins at the bottom are the trainers' gauges, under the names
the reference's `obs` tools read: step time, throughput, input wait
(`input_wait_frac`), device memory (`hbm_live_mb`, `hbm_peak_mb`) and
MFU (`mfu`). The reference takes a step's FLOPs from XLA's cost
analysis; the port has no compiler to ask, so `compiled_flops` counts
one step's products with `torch.utils.flop_counter` on a shape-only
(meta) twin of the model.
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


# ------------------------------------------------------------ built-ins


def observe_step(
    reg: MetricsRegistry, duration_s: float, tokens: int | None = None,
    samples: int | None = None,
) -> None:
    """One step's duration (+ what it processed) into the step-time
    histogram/EMA and the work counters. On a card a per-step host
    duration is launch time, not device time — so this feeds the
    histogram and counters but NOT the throughput gauges, which come
    from `observe_throughput` with the epoch's synchronized duration."""
    ms = duration_s * 1e3
    reg.histogram("step_time_ms").observe(ms)
    reg.gauge("step_time_ema_ms").ema(ms)
    reg.counter("steps").inc()
    if tokens:
        reg.counter("tokens").inc(tokens)
    if samples:
        reg.counter("samples").inc(samples)


def observe_throughput(
    reg: MetricsRegistry, duration_s: float, steps: int,
    tokens: int | None = None, samples: int | None = None,
) -> None:
    """Throughput gauges from a synchronized wall-clock window covering
    `steps` steps (tokens/samples are totals over the window), and the
    per-step time `step_time_fenced_ms` that MFU divides by."""
    if duration_s <= 0 or steps <= 0:
        return
    reg.gauge("step_time_fenced_ms").set(duration_s / steps * 1e3)
    if tokens:
        reg.gauge("tokens_per_s").set(tokens / duration_s)
    if samples:
        reg.gauge("samples_per_s").set(samples / duration_s)


def observe_input_wait(
    reg: MetricsRegistry, wait_s: float, window_s: float | None = None,
) -> None:
    """Time the step loop spent BLOCKED on the input queue over one
    epoch window (`data.prefetch.Prefetcher.wait_s`), and the
    data-starved fraction of that window."""
    reg.gauge("input_wait_s").set(wait_s)
    if window_s and window_s > 0:
        reg.gauge("input_wait_frac").set(min(wait_s / window_s, 1.0))


def observe_device_memory(reg: MetricsRegistry, device=None) -> None:
    """Allocator live/peak bytes as MB gauges; the CPU reports None,
    not 0 — absent evidence stays distinguishable from an empty card."""
    from hyperion_tpu_torch.utils.memory import device_memory_stats

    stats = device_memory_stats(device)
    live = stats.get("bytes_in_use")
    peak = stats.get("peak_bytes_in_use", live)
    reg.gauge("hbm_live_mb").set(None if live is None else live / 1e6)
    g = reg.gauge("hbm_peak_mb")
    mb = None if peak is None else peak / 1e6
    # high-water: a later epoch must never lower the reported peak
    if mb is not None and (g.value is None or mb > g.value):
        g.set(mb)


def compiled_flops(model, loss_fn, batch: dict) -> float | None:
    """FLOPs of one train step's forward and backward: `loss_fn(twin,
    batch)` and its backward, counted by `FlopCounterMode` on a twin of
    `model` built on the meta device (shapes only: no memory, no
    kernels) with the plain attention and norms, whose products the
    counter sees (the hand kernels are ctypes calls it cannot). Each
    twin parameter takes its original's dtype and `requires_grad`, so a
    frozen LoRA base runs no weight-gradient products, and remat's
    recompute is counted as it runs. Elementwise work (the optimizer's
    update, softmax, norms) is not a product and is not counted; XLA's
    cost analysis counts it too, so the reference's count is the
    larger. None when the model cannot be rebuilt so."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    try:
        cfg = dataclasses.replace(model.cfg, **{
            k: "xla" for k in ("attention_impl", "norm_impl")
            if hasattr(model.cfg, k)})
        # the MoE and pipelined LMs wrap the base config in their own
        if hasattr(model, "with_base"):
            cfg = model.with_base(cfg)
        twin = type(model)(cfg, device="meta")
        live = dict(model.named_parameters())
        for name, p in twin.named_parameters():
            p.data = p.data.to(live[name].dtype)
            p.requires_grad_(live[name].requires_grad)
        meta = {k: torch.empty_like(v, device="meta")
                for k, v in batch.items()}
        with FlopCounterMode(display=False) as counter:
            loss_fn(twin, meta).backward()
        flops = counter.get_total_flops()
        return float(flops) if flops > 0 else None
    except Exception:  # noqa: BLE001 — telemetry must never kill a run
        return None


_MEASURED_HOST_PEAK: list[float | None] = []  # one-element memo


def _measured_host_peak_tflops() -> float | None:
    """Fallback "peak" for devices `utils.chips` does not tabulate (the
    CPU): the best achieved TFLOP/s of a 256 fp32 matmul, measured once
    per process. Model FLOP throughput on the same host is bounded by
    it, so the derived MFU stays in (0, 1] — utilisation *of this
    host's measured matmul rate*, labelled `mfu_peak_source:
    "measured_host"`, never comparable to a nominal-peak MFU."""
    if _MEASURED_HOST_PEAK:
        return _MEASURED_HOST_PEAK[0]
    try:
        import torch

        n = 256
        a = torch.ones(n, n)
        b = torch.ones(n, n) / n
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(8):
                a = a @ b
            best = min(best, (time.perf_counter() - t0) / 8)
        peak = 2 * n ** 3 / best / 1e12
        _MEASURED_HOST_PEAK.append(peak if peak > 0 else None)
    except Exception:  # noqa: BLE001
        _MEASURED_HOST_PEAK.append(None)
    return _MEASURED_HOST_PEAK[0]


def mfu_value(
    flops_per_step: float | None,
    step_time_s: float,
    *,
    dtype: str = "bfloat16",
    n_devices: int = 1,
    peak_tflops: float | None = None,
    device=None,
) -> tuple[float | None, str]:
    """(mfu fraction, peak source): `flops / (t * peak * n_devices)`;
    the peak is the explicit argument, else the device's datasheet peak
    (`utils.chips.nominal_peak_tflops`), else the measured host rate,
    else None."""
    if not flops_per_step or step_time_s <= 0:
        return None, "none"
    source = "explicit"
    if peak_tflops is None:
        from hyperion_tpu_torch.utils.chips import nominal_peak_tflops

        peak_tflops = nominal_peak_tflops(dtype, device)
        source = "nominal"
    if peak_tflops is None:
        peak_tflops = _measured_host_peak_tflops()
        source = "measured_host"
    if not peak_tflops:
        return None, "none"
    mfu = flops_per_step / (step_time_s * peak_tflops * 1e12 * n_devices)
    return mfu, source


def observe_mfu(
    reg: MetricsRegistry,
    flops_per_step: float | None,
    step_time_s: float,
    *,
    dtype: str = "bfloat16",
    n_devices: int = 1,
    device=None,
) -> float | None:
    mfu, source = mfu_value(flops_per_step, step_time_s, dtype=dtype,
                            n_devices=n_devices, device=device)
    reg.gauge("mfu").set(mfu)
    if mfu is not None:
        reg.gauge("flops_per_step").set(flops_per_step)
        reg.set_label("mfu_peak_source", source)
    return mfu
