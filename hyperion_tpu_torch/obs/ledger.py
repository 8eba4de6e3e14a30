"""Compile ledger — the recompile-free invariant as a RUNTIME signal.

Tier-1 asserts `compile_stats()` stays flat after warmup; production
had no equivalent until now — a shape that slipped past the bucket
ladder would retrace silently, and the only symptom would be a
latency cliff nobody could attribute. The ledger closes that gap:

  * `record_warmup()` captures the one-shot warmup story — per-
    executable compile wall-time and (opt-in) `cost_analysis()`
    FLOPs/bytes — which the engine emits as a `compile_ledger` event.
  * `set_baseline()` pins the post-warmup executable counts.
  * `check()` runs every tick on the host ints `compile_stats()`
    already returns (4 dict reads, no device interaction): any growth
    returns the named executables so the engine can raise the
    `serve_recompiles` counter, a `recompile_after_warmup` event with
    churn context, and a flight-recorder note — the `obs diff` gate
    pins the counter at zero.

Caveat, documented rather than papered over: the jit caches are
process-wide (`engine._shared_jits`), so a SECOND engine warming new
shapes in the same process grows the counts this ledger watches. Only
growth observed between one engine's own ticks is attributed — the
deployment entry points run one engine per process, where the signal
is exact.
"""

from __future__ import annotations


class CompileLedger:
    """Host-side executable-count ledger for one engine."""

    def __init__(self):
        self._last_seen: dict[str, int] = {}
        self._baselined = False
        self.recompiles = 0          # executables added after warmup
        self.warmup: dict | None = None

    @property
    def last_seen(self) -> dict:
        """The most recent counts `check()`/`set_baseline()` saw —
        what the exposition payload reports, so answering a poll never
        has to touch the jit caches from a foreign thread."""
        return dict(self._last_seen)

    def record_warmup(self, stats: dict, *, compile_s: dict | None = None,
                      costs: dict | None = None,
                      total_s: float | None = None) -> dict:
        """One-shot warmup record: final counts + per-executable wall
        seconds + optional AOT cost analysis. Returns the event-ready
        dict (flat keys, JSON-safe)."""
        self.warmup = {
            "stats": dict(stats),
            "compile_s": dict(compile_s or {}),
            "costs": dict(costs or {}),
            "total_s": total_s,
        }
        return self.warmup

    def set_baseline(self, stats: dict) -> None:
        """Pin the post-warmup counts; `check()` is a no-op until this
        runs (an engine that never warmed has no invariant to hold)."""
        self._last_seen = {k: int(v) for k, v in stats.items()}
        self._baselined = True

    def check(self, stats: dict) -> list[dict]:
        """Compare fresh counts against the last-seen ones; return one
        record per grown executable (empty = invariant holds) and
        advance last-seen so each growth reports exactly once."""
        if not self._baselined:
            return []
        growth: list[dict] = []
        for name, after in stats.items():
            after = int(after)
            before = self._last_seen.get(name, after)
            if after > before:
                growth.append({"executable": name, "before": before,
                               "after": after})
                self.recompiles += after - before
            self._last_seen[name] = after
        return growth
