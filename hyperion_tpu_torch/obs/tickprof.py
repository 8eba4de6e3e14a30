"""Host-tick profiler + crash flight recorder — where a tick's host
time goes, and what the last ticks looked like when a process died.

The engine's recompile-free / zero-device-sync invariants make the
DEVICE side of a tick boring by construction; what actually moves
tokens/s run to run is the HOST side — queue pops, draft building,
block-table uploads, the accept loop, journal fsyncs, client sink
writes, SLO evaluation. `engine.step()` already stamps most of these
with ad-hoc `time.monotonic()` pairs; this module formalizes them:

  * `TickProfiler` — a bounded ring of per-tick segment records. The
    engine builds one small dict of host-second floats per step and
    `record()`s it; `snapshot(window_s)` rolls the last-N-seconds into
    per-segment totals/fractions plus the DOMINANT segment, riding the
    exposition payload so `obs top` can show each row's hot segment
    and `obs doctor` can name it when tokens/s degrades ("journal owns
    61% of tick time — slow disk").
  * `FlightRecorder` — the post-mortem half. The tick ring's tail plus
    recent notable events spill periodically (and on SIGTERM / fatal
    exception) to `flight.json` next to the heartbeat, atomically, so
    even a watchdog SIGKILL leaves the last spill on disk. The FIRST
    eligible spill fires immediately — a replica chaos-killed at tick
    2 still leaves evidence. `obs doctor` cites the record's final
    ticks in its crashed/hung verdicts.

Both are host-only (no jax import) and null-safe: a recorder built
with `path=None` accepts every call and writes nothing, the same
contract as the null tracer/heartbeat.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path

FLIGHT_SCHEMA = 1
FLIGHT_NAME = "flight.json"

# the segment vocabulary (SERVING.md "Profiling and post-mortems"):
# every recorded tick carries a subset of these keys, seconds each.
# "other" is derived at snapshot time (total minus named segments) so
# unattributed host time is visible instead of silently vanishing.
SEGMENTS = ("queue_pop", "admit", "chunk", "draft", "bt_upload",
            "device", "accept", "journal", "sink", "slo")


class TickProfiler:
    """Bounded ring of per-tick host-segment records.

    The writer (the engine thread) appends one dict per step; readers
    (the exposition thread, the flight recorder) take list() copies of
    the deque — append/copy on a deque are safe under the GIL, so no
    lock sits on the hot path."""

    def __init__(self, capacity: int = 256, wall=time.time):
        self._ring: deque[dict] = deque(maxlen=max(8, int(capacity)))
        self._wall = wall
        self.ticks_recorded = 0

    def record(self, tick: int, segments: dict, total_s: float) -> None:
        """One step's breakdown: `segments` maps SEGMENTS names to host
        seconds (absent = 0), `total_s` is the whole step's wall."""
        self.ticks_recorded += 1
        self._ring.append({
            "tick": int(tick),
            "t_wall": self._wall(),
            "total_s": float(total_s),
            "s": {k: round(float(v), 6) for k, v in segments.items() if v},
        })

    def tail(self, n: int = 32) -> list[dict]:
        """The most recent <= n records (flight-record payload)."""
        items = list(self._ring)
        return items[-n:]

    def snapshot(self, window_s: float = 60.0,
                 now: float | None = None) -> dict:
        """Windowed roll-up: per-segment seconds + fraction of the
        summed step wall, and the dominant segment. Fractions are of
        TOTAL step time, so "device 0.92" reads directly as "92% of
        tick wall went to the device dispatch+wait"."""
        now = self._wall() if now is None else now
        cut = now - window_s
        recs = [r for r in self._ring if r["t_wall"] >= cut]
        total = sum(r["total_s"] for r in recs)
        sums: dict[str, float] = {}
        for r in recs:
            for k, v in r["s"].items():
                sums[k] = sums.get(k, 0.0) + v
        named = sum(sums.values())
        if total > named:
            sums["other"] = total - named
        segs = {
            k: {"s": round(v, 6),
                "frac": round(v / total, 4) if total > 0 else 0.0}
            for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
        }
        dominant = next(iter(segs), None)
        return {
            "ticks": len(recs),
            "window_s": window_s,
            "total_s": round(total, 6),
            "segments": segs,
            "dominant": dominant,
            "dominant_frac": segs[dominant]["frac"] if dominant else None,
        }


class FlightRecorder:
    """Atomic spiller of the last-known engine state to `flight.json`.

    The caller (the engine) owns WHAT goes in a spill — the recorder
    owns WHEN (first eligible tick, then every `spill_every`) and HOW
    (same-directory temp + `os.replace`, the heartbeat's torn-write
    discipline). `note()` collects sparse notable events (recompiles,
    journal errors, chaos fires) into a bounded deque that rides every
    spill."""

    def __init__(self, path: str | Path | None, *, run: str | None = None,
                 spill_every: int = 16, max_events: int = 64,
                 wall=time.time):
        self.path = Path(path) if path else None
        self.enabled = self.path is not None
        self.run = run
        self.spill_every = max(1, int(spill_every))
        self.events: deque[dict] = deque(maxlen=max(4, int(max_events)))
        self._wall = wall
        self._last_spill_tick: int | None = None
        self.spills = 0

    def note(self, name: str, **attrs) -> None:
        """Record a notable moment (rides the next spill)."""
        if not self.enabled:
            return
        self.events.append({"name": name, "t_wall": self._wall(), **attrs})

    def due(self, tick: int) -> bool:
        """Periodic-spill policy: the FIRST call is always due (a crash
        at tick 2 must still find evidence on disk), then every
        `spill_every` ticks."""
        if not self.enabled:
            return False
        return (self._last_spill_tick is None
                or tick - self._last_spill_tick >= self.spill_every)

    def spill(self, reason: str, payload: dict | None = None, *,
              tick: int | None = None) -> None:
        """Unconditional atomic write. `payload` is the caller's state
        dump (tick ring tail, compile ledger, memory); the recorder
        adds the envelope + its event buffer. IO failure degrades the
        recorder, never the process — same posture as the heartbeat."""
        if not self.enabled:
            return
        self.spills += 1
        if tick is not None:
            self._last_spill_tick = tick
        rec = {
            "v": FLIGHT_SCHEMA,
            "run": self.run,
            "pid": os.getpid(),
            "t_wall": self._wall(),
            "reason": reason,
            "tick": tick,
            "spills": self.spills,
            "events": list(self.events),
            **(payload or {}),
        }
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_name(self.path.name + ".tmp")
            tmp.write_text(json.dumps(rec, separators=(",", ":"),
                                      default=repr))
            os.replace(tmp, self.path)
        except OSError:
            self.enabled = False


def null_flight_recorder() -> FlightRecorder:
    return FlightRecorder(None)


def read_flight(path: str | Path) -> dict | None:
    """Tolerant flight-record reader (doctor's side): None when missing
    or unparseable — the atomic writer makes a torn file near
    impossible, but a reader must never crash on one."""
    try:
        rec = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def flight_final_tick(flight: dict) -> int | None:
    """The last tick the record saw — the spill's own tick stamp, or
    the newest ring entry's."""
    t = flight.get("tick")
    if isinstance(t, int):
        return t
    ticks = flight.get("ticks")
    if isinstance(ticks, list) and ticks:
        last = ticks[-1]
        if isinstance(last, dict) and isinstance(last.get("tick"), int):
            return last["tick"]
    return None
