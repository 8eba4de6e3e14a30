"""Windowed SLO targets and multi-window burn-rate alerting — a copy of
`hyperion_tpu/obs/slo.py` over the port's registry.

A dashboard shows numbers; an SLO says which numbers are FAILURES. This
module evaluates declarative targets — TTFT p99, reject rate,
availability — against the live windowed instruments (obs/registry.py)
with the standard multi-window burn-rate discipline: an alert RAISES
only when both a fast window (default 1 minute — "is it bad right
now?") and a slow window (default 10 minutes — "has it been bad long
enough to matter?") burn error budget at >= 1x, and CLEARS only when
both windows are back under the clear ratio. The two windows plus the
clear ratio are the hysteresis: a metric hovering exactly at its
threshold raises once and stays raised; a single bad second never
pages, and a recovered system never flaps the alert on its way down
(the slow window remembers the incident until it has actually drained).

Burn rate is error budget spent per unit budget:

    ttft_p99_ms / reject_rate   burn = value / threshold
    availability                burn = (1 - value) / (1 - threshold)

An empty window (no traffic) burns 0.0 — no requests means no SLO
violations, which is what lets alerts clear after a drain.

`SLOMonitor` is pure host arithmetic over one `MetricsRegistry` with an
injectable clock and value function, so the hysteresis contract is
unit-testable without an engine; the engine/router loops call
`evaluate()` (internally rate-limited) and hand the transitions to
`publish()`, which emits the standard `alert_raised`/`alert_cleared`
telemetry events and bumps the `*_alerts_raised`/`*_alerts_cleared`
counters `obs doctor`, `obs diff`, and the bench serving row read.
"""

from __future__ import annotations

import dataclasses
import math
import time

DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
CLEAR_RATIO = 0.9

# the metric vocabulary `serve_window_value` understands (the engine's
# standard serving SLOs); custom fleets inject their own value_fn
METRICS = ("ttft_p99_ms", "reject_rate", "availability")


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One declarative objective. `threshold` is the budget boundary:
    an upper bound for latencies/rates, a lower bound for
    availability (the burn formula, not a direction flag, encodes
    which — see `burn`). `min_count` is the evidence floor for
    QUANTILE metrics: a window holding fewer observations reports no
    value (burn 0) — the p99 of one cold request is that request, and
    paging on it would break the 'a single bad second never pages'
    contract. Rate metrics dilute naturally and ignore it."""

    name: str                    # alert name on the telemetry stream
    metric: str                  # see METRICS (or a value_fn's own key)
    threshold: float
    clear_ratio: float = CLEAR_RATIO   # hysteresis: clear at burn <= this
    min_count: int = 1           # quantile evidence floor per window


QUANTILE_MIN_COUNT = 5


def standard_targets(ttft_p99_ms: float = 0.0, reject_rate: float = 0.0,
                     availability: float = 0.0,
                     min_count: int = QUANTILE_MIN_COUNT,
                     ) -> tuple[SLOTarget, ...]:
    """The serving trio from plain numbers (0 = target off) — the shape
    the `hyperion serve --slo-*` flags configure. The latency target
    carries the quantile evidence floor (`min_count`)."""
    out: list[SLOTarget] = []
    if ttft_p99_ms > 0:
        out.append(SLOTarget("ttft_p99", "ttft_p99_ms",
                             float(ttft_p99_ms), min_count=min_count))
    if reject_rate > 0:
        out.append(SLOTarget("reject_rate", "reject_rate",
                             float(reject_rate)))
    if availability > 0:
        out.append(SLOTarget("availability", "availability",
                             float(availability)))
    return tuple(out)


def counter_ratio(reg, num_names, den_names, window_s: float,
                  now: float | None = None) -> float | None:
    """num/(num+den) over the COMMON covered span of every involved
    counter ring: a busy counter whose ring wrapped inside the window
    covers less history than a rare one, and mixing their raw deltas
    would inflate the ratio (a 50/s accept stream truncated to 160s
    against a 1/s reject stream covering all 600s reads as 3.5x the
    true reject rate). Clamping every delta to the shortest covered
    span keeps the ratio exact over the history all rings still hold.
    None = no events in the span (silence, not a breach)."""
    counters = [reg.counter(n) for n in (*num_names, *den_names)]
    span = min(c.covered_window_s(window_s, now) for c in counters)
    if span <= 0:
        return None
    num = sum(reg.counter(n).windowed_delta(span, now)
              for n in num_names)
    den = sum(reg.counter(n).windowed_delta(span, now)
              for n in den_names)
    total = num + den
    return num / total if total > 0 else None


def serve_window_value(reg, metric: str, window_s: float,
                       now: float | None = None,
                       min_count: int = 1) -> float | None:
    """Windowed value of one serving SLO metric from the engine's
    registry (serve/metrics.py instrument names). None = no traffic in
    the window — the caller treats that as zero burn, not as a breach.
    For the quantile metric, a window with fewer than `min_count`
    observations is also None: too sparse to be evidence."""
    if metric == "ttft_p99_ms":
        w = reg.histogram("ttft_ms").windowed(window_s, now)
        if w.get("count", 0) < max(1, min_count):
            return None
        return w.get("p99")
    if metric == "reject_rate":
        return counter_ratio(reg, ("serve_rejected",),
                             ("serve_accepted",), window_s, now)
    if metric == "availability":
        return counter_ratio(reg, ("serve_completed",),
                             ("serve_rejected", "serve_timed_out"),
                             window_s, now)
    raise ValueError(f"unknown SLO metric {metric!r} (expected one of "
                     f"{METRICS})")


def burn(metric: str, value: float | None, threshold: float) -> float:
    """Error-budget burn rate: 1.0 = consuming the budget exactly.
    None (empty window) burns nothing — silence is compliance."""
    if value is None:
        return 0.0
    if metric == "availability":
        budget = 1.0 - threshold
        if budget <= 0:       # a 100% target has zero budget:
            return 0.0 if value >= 1.0 else math.inf
        return (1.0 - value) / budget
    if threshold <= 0:
        return 0.0 if value <= 0 else math.inf
    return value / threshold


class SLOMonitor:
    """Burn-rate state machine over one registry. `evaluate()` is
    cheap and internally rate-limited (default: 4x per fast window, at
    most once a second) so the serve loop can call it every tick."""

    def __init__(self, targets, registry, *,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 value_fn=serve_window_value,
                 eval_every_s: float | None = None,
                 clock=time.monotonic):
        if slow_s < fast_s:
            raise ValueError(f"slow window {slow_s}s must cover the "
                             f"fast one ({fast_s}s)")
        self.targets = tuple(targets)
        self.reg = registry
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self._value_fn = value_fn
        self._clock = clock
        self.eval_every_s = (min(1.0, self.fast_s / 4.0)
                             if eval_every_s is None else eval_every_s)
        self._last_eval: float | None = None
        self.active: dict[str, float] = {}   # alert name -> raised at

    def active_names(self) -> list[str]:
        return sorted(self.active)

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Advance every target's state machine; returns the
        transitions ({"kind": "raised"|"cleared", ...}) that happened,
        [] when rate-limited or nothing moved."""
        now = self._clock() if now is None else now
        if self._last_eval is not None \
                and now - self._last_eval < self.eval_every_s:
            return []
        self._last_eval = now
        out: list[dict] = []
        for t in self.targets:
            vf = self._value_fn(self.reg, t.metric, self.fast_s, now,
                                t.min_count)
            vs = self._value_fn(self.reg, t.metric, self.slow_s, now,
                                t.min_count)
            bf = burn(t.metric, vf, t.threshold)
            bs = burn(t.metric, vs, t.threshold)
            if t.name not in self.active:
                # raise: BOTH windows burning at >= 1x — bad now AND
                # bad long enough that it is not one unlucky second
                if bf >= 1.0 and bs >= 1.0:
                    self.active[t.name] = now
                    out.append({
                        "kind": "raised", "alert": t.name,
                        "metric": t.metric, "threshold": t.threshold,
                        "fast": vf, "slow": vs,
                        "burn_fast": round(bf, 4),
                        "burn_slow": round(bs, 4),
                    })
            elif bf <= t.clear_ratio and bs <= t.clear_ratio:
                # clear: BOTH windows comfortably under budget — the
                # clear ratio plus the slow window's memory is the
                # no-flap guarantee
                since = self.active.pop(t.name)
                out.append({
                    "kind": "cleared", "alert": t.name,
                    "metric": t.metric, "threshold": t.threshold,
                    "fast": vf, "slow": vs,
                    "active_s": round(now - since, 3),
                })
        return out


def publish(transitions: list[dict], tracer, registry, *,
            step: int | None = None, prefix: str = "serve",
            active: int | None = None) -> None:
    """Turn transitions into the standard wire vocabulary: one
    `alert_raised`/`alert_cleared` event each (eagerly flushed, like
    every event) plus the `{prefix}_alerts_raised`/`_cleared` counters
    and the `{prefix}_alerts_active` gauge the snapshot consumers
    (doctor evidence, diff gate, bench rows) read back. `active` (the
    monitor's post-transition active count) refreshes the gauge."""
    if active is not None:
        registry.gauge(f"{prefix}_alerts_active").set(float(active))
    for tr in transitions:
        if tr["kind"] == "raised":
            registry.counter(f"{prefix}_alerts_raised").inc()
            tracer.event(
                "alert_raised", step=step, alert=tr["alert"],
                metric=tr["metric"], threshold=tr["threshold"],
                fast=tr["fast"], slow=tr["slow"],
                burn_fast=tr["burn_fast"], burn_slow=tr["burn_slow"])
        else:
            registry.counter(f"{prefix}_alerts_cleared").inc()
            tracer.event(
                "alert_cleared", step=step, alert=tr["alert"],
                metric=tr["metric"], threshold=tr["threshold"],
                active_s=tr["active_s"])
