"""Replica handles — the router's host-side view of one engine process.

A replica is a full `hyperion serve` child (its own unix socket, its
own request journal, its own telemetry dir and heartbeat file) that the
router (`serve/router.py`) spawns under the shared supervisor core.
This module is the ROUTER-side bookkeeping for one such child: where
its artifacts live, what its last heartbeat said, and the small
ejection/readmission state machine the dispatch policy consults.

The state machine is deliberately pure host logic — every transition
takes explicit timestamps, nothing here touches a device, sockets, or
processes — so the dispatch-policy tests (`tests/test_router.py`) can
drive a whole fleet through crash/recover cycles in microseconds.

States:

    starting — spawned, no serve-phase heartbeat yet: not dispatchable
    ready    — beating in a serve phase: dispatchable
    ejected  — stale heartbeat, connection error, or child exit: the
               router stops dispatching; in-flight requests recover via
               re-dispatch (deterministic seeds make the continuation
               bit-identical on any replica) while the dead child's own
               journal replays sink-less on restart

Readmission is heartbeat-gated: only a beat *newer than the ejection*
in a serve phase flips `ejected -> ready` — a crashed child's stale
heartbeat file, still on disk, can never talk its way back in.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

STARTING = "starting"
READY = "ready"
EJECTED = "ejected"

# heartbeat phases that mean "the engine loop is accepting work" —
# load/warmup beats prove liveness but not serveability, and drain/done
# beats mean the door is (or will be) shut
SERVE_PHASES = ("serve", "serve_idle")


@dataclasses.dataclass
class ReplicaHandle:
    """One replica's paths, last-observed heartbeat, and router-side
    load accounting."""

    index: int
    socket_path: str = ""
    telemetry_path: str = ""     # the child's own JSONL stream
    heartbeat_path: str = ""
    journal_path: str = ""
    state: str = STARTING

    # --- last observed heartbeat payload (engine beats carry
    #     active/queue on serve, idle, AND terminal pulses) ---
    hb_t_wall: float | None = None
    hb_phase: str | None = None
    hb_active: int = 0
    hb_queue: int = 0
    hb_pid: int | None = None
    # SLO alerts the replica reported on its last beat (obs/slo.py via
    # the engine's `alerts` heartbeat field) — the router's monitor
    # tallies these fleet-wide and `obs top` shows them per row
    hb_alerts: tuple = ()
    # hot prefix roots the replica advertised (serve/hostcache.py
    # digests via the engine's `prefix_roots` heartbeat field) — the
    # dispatch policy's cache-aware term steers matching requests here
    hb_prefix_roots: tuple = ()

    # --- router-side accounting ---
    # dispatches newer than the last beat: the beat's active/queue
    # cannot see them yet, so the score adds them explicitly — without
    # this, a burst between beats lands entirely on one replica
    dispatched_since_beat: int = 0
    inflight: int = 0            # open relay streams right now
    dispatched_total: int = 0
    ejected_at: float | None = None   # wall time of the last ejection
    eject_reason: str | None = None
    restarts: int = 0

    # --- acting-router state ---
    # steered: a burning TTFT alert moved interactive traffic off this
    # replica (batch still flows — the point is protecting the latency
    # tier, not starving the replica). Unsteer is hysteresis-gated:
    # `steer_clear_sweeps` counts CONSECUTIVE alert-free monitor sweeps,
    # and only crossing the router's threshold flips steered back off.
    steered: bool = False
    steer_clear_sweeps: int = 0
    # standby: spawned by the scale governor (not part of the base
    # fleet); retiring standbys exit instead of restarting on next exit
    standby: bool = False
    retiring: bool = False
    # adopted: a restarted router found this replica's previous-life
    # child still alive and serving (fresh serve-phase heartbeat, pid
    # answers) and took it over WITHOUT a respawn — there is no Popen
    # handle for it, so shutdown signals it by heartbeat pid instead
    adopted: bool = False

    @classmethod
    def under(cls, base_dir: str | Path, index: int) -> "ReplicaHandle":
        """The canonical layout: everything for replica i lives in
        `<base>/replica_<i>/` — the directory `obs doctor`'s fleet view
        discovers by name."""
        d = Path(base_dir) / f"replica_{index}"
        return cls(
            index=index,
            socket_path=str(d / "sock"),
            telemetry_path=str(d / "telemetry.jsonl"),
            heartbeat_path=str(d / "heartbeat.json"),
            journal_path=str(d / "journal.jsonl"),
        )

    @property
    def dir(self) -> Path:
        return Path(self.socket_path).parent

    # ------------------------------------------------------------ load

    def load_score(self) -> int:
        """Least-loaded dispatch score: what the replica said it was
        carrying (active slots + queue depth from its last beat) plus
        what the router has sent since that beat."""
        return self.hb_active + self.hb_queue + self.dispatched_since_beat

    # --------------------------------------------------- state machine

    def observe_beat(self, hb: dict | None, now: float) -> str | None:
        """Feed one parsed heartbeat record (or None). Returns "ready"
        when this beat readmits (or first-admits) the replica,
        "ejected" when a fresh beat shows a READY replica has LEFT the
        serve phases (draining/done: still beating, but the door is
        shut — dispatching there would bounce every request off its
        closed queue), else None. A beat is only NEW when its wall
        stamp advanced — re-reading an unchanged file is a no-op."""
        if not isinstance(hb, dict):
            return None
        t = hb.get("t_wall")
        if not isinstance(t, (int, float)):
            return None
        fresh = self.hb_t_wall is None or float(t) > self.hb_t_wall
        if not fresh:
            return None
        self.hb_t_wall = float(t)
        self.hb_phase = hb.get("phase")
        self.hb_active = int(hb.get("active") or 0)
        self.hb_queue = int(hb.get("queue") or 0)
        self.hb_pid = hb.get("pid") if isinstance(hb.get("pid"), int) \
            else self.hb_pid
        alerts = hb.get("alerts")
        self.hb_alerts = (tuple(str(a) for a in alerts)
                          if isinstance(alerts, (list, tuple)) else ())
        roots = hb.get("prefix_roots")
        self.hb_prefix_roots = (tuple(str(r) for r in roots)
                                if isinstance(roots, (list, tuple))
                                else ())
        self.dispatched_since_beat = 0
        if self.state in (STARTING, EJECTED) \
                and self.hb_phase in SERVE_PHASES \
                and (self.ejected_at is None or self.hb_t_wall > self.ejected_at):
            self.state = READY
            self.ejected_at = None
            self.eject_reason = None
            return "ready"
        if self.state == READY and self.hb_phase not in SERVE_PHASES:
            self.eject(now, f"left serve phase ({self.hb_phase!r})")
            return "ejected"
        return None

    def check_stale(self, now: float, stale_s: float) -> str | None:
        """Eject a READY replica whose heartbeat stopped advancing:
        returns the eject reason on a transition, else None."""
        if self.state != READY or stale_s <= 0:
            return None
        last = self.hb_t_wall
        if last is None or now - last > stale_s:
            age = (now - last) if last is not None else None
            return self.eject(
                now,
                f"heartbeat stale ({age:.1f}s > {stale_s:.1f}s)"
                if age is not None else "no heartbeat")
        return None

    def eject(self, now: float, reason: str) -> str:
        """Mark not-dispatchable (stale beat / connection error / child
        exit). Idempotent; the FIRST reason sticks — it is the one that
        actually took the replica out."""
        if self.state != EJECTED:
            self.state = EJECTED
            self.ejected_at = now
            self.eject_reason = reason
        return self.eject_reason or reason

    @property
    def ready(self) -> bool:
        return self.state == READY
