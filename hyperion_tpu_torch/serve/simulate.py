"""Fleet flight simulator — `hyperion simulate <scenario>`; a copy of
`hyperion_tpu/serve/simulate.py` over the port's policy objects. Its
reports and telemetry equal the reference's for the same scenario and
seed, and the port's `obs doctor` and `obs diff` read them unchanged.

Every scheduling/placement policy in the serving stack (queue class
lanes, brownout governors, steer/scale hysteresis, affinity, exactly-
once failover, the replica readiness state machine) is host-side Python
with an injectable clock. This module exploits that: a discrete-event
scheduler (virtual clock + event heap) drives the REAL policy objects —
`RouterPolicy`, `FleetActions`, `AdmissionQueue`, `BrownoutGovernor`,
`ReplicaHandle`, `SLOMonitor`, `StreamDedup` — while replicas are
modeled by a synthetic token-timing model (prefill/decode/restart
latencies as scenario data, no engine, no torch, no device). One
pytest process plays out hours of traffic over hundreds of simulated
replicas and ~10^6 requests in seconds.

The assertion language is the obs plane itself: every policy decision
lands on a virtual-clocked `MetricsRegistry` and a standard telemetry
stream (`Tracer` + `Heartbeat` on the same virtual clock), so `obs
doctor`, `obs diff`, and the windowed SLO burn alerts consume simulator
output unchanged. A scenario is pure data — a dict of arrival curves,
tenant mixes, a fault schedule, fleet timing, and assertion thresholds
over the exported metrics — and the starter library below covers the
classic metastable-failure regimes: thundering-herd cold start,
regional failover (half the fleet dies at once), a cache-cold restart
storm, an adversarial tenant mix, and slow-burn replica degradation.

Fidelity notes (what is real vs modeled):

* REAL: dispatch/affinity/steering choice, queue admission + weighted-
  fair pop + deadline shed/expiry, brownout hysteresis, readiness/
  ejection/readmission off heartbeat dicts, fleet-alert tallying,
  steer/scale sweeps (`FleetActions` — the same object the live Router
  drives), SLO burn-rate evaluation, stream-index dedup on failover.
* MODELED: token timing (prefill/decode ms per token, scaled by a
  degradation factor and a cold-cache window after restart), replica
  death/restart (a killed replica loses its queue exactly like a dead
  process), and heartbeats (in-memory dicts refreshed each sweep —
  the same schema `read_heartbeat` would parse from disk).

Telemetry volume is bounded: per-request events (`route_dispatch`,
`route_complete`, `request_admitted`, ...) are SAMPLED (every Nth
request) — aggregate truth lives in the registry snapshots the tracer
spills every `snapshot_s` of virtual time; the doctor's tenant/event
tables therefore show sampled counts while every asserted number comes
from the full-population counters.
"""

from __future__ import annotations

import argparse
import heapq
import itertools
import json
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

from hyperion_tpu_torch.obs import slo as slo_mod
from hyperion_tpu_torch.obs.heartbeat import Heartbeat
from hyperion_tpu_torch.obs.registry import MetricsRegistry, percentile
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.serve.metrics import RouterMetrics, ServeMetrics
from hyperion_tpu_torch.serve.queue import (
    AdmissionQueue,
    BrownoutGovernor,
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    REJECT_NO_REPLICA,
    REJECT_QUEUE_FULL,
    REJECT_SHED,
    Request,
)
from hyperion_tpu_torch.serve.replica import READY, ReplicaHandle
from hyperion_tpu_torch.serve.router import FleetActions, RouterPolicy, StreamDedup
from hyperion_tpu_torch.utils.clock import VirtualClock

# the fixture wall epoch (tests/data/telemetry/gen_fixtures.py): sim
# telemetry defaults to the same calendar base so golden streams are
# stable and recognizably synthetic
WALL0 = 1754000000.0
MONO0 = 100.0

# ----------------------------------------------------------------- data

# Scenario schema (all pure data — no callables, no classes):
#   name        str
#   replicas    int — base fleet size (CLI --replicas overrides)
#   duration_s  float — virtual seconds of arrivals
#   requests    int — total arrivals (CLI --requests overrides)
#   seed        int — the only entropy source
#   arrival     [[from_frac, to_frac, weight], ...] — piecewise-uniform
#               arrival density over the duration
#   tenants     [{tenant, share, sla_class, prompt_len:[lo,hi], max_new,
#                 deadline_s, sessions, prompts}] — `sessions` > 0 keys
#               affinity by session id; `prompts` > 0 draws prompt ids
#               from that many distinct pooled prompts (prefix affinity)
#   fleet       timing + sizing knobs (see DEFAULT_FLEET)
#   router      act/steer/scale/sweep knobs (see DEFAULT_ROUTER)
#   slo         serve-level burn-alert targets (0 disables a target)
#   faults      [{t, kind: kill|restart|degrade|recover, replicas:
#                 [idx...] | "half" | int}] — kill takes replicas down
#               (queue lost); restart_s later they beat again
#   assert      {report_key: {"max": v} | {"min": v}} over report()

DEFAULT_FLEET = {
    "n_slots": 4,
    "queue_capacity": 64,
    "prefill_budget": 512,
    "max_total_tokens": 4096,
    "prefill_ms_per_token": 0.4,
    "decode_ms_per_token": 8.0,
    "restart_s": 15.0,
    "cold_factor": 4.0,          # prefill cost multiplier after restart
    "cold_s": 20.0,              # ...for this long
    "ready_stagger_s": 0.0,      # replica i first beats at i*stagger
    "ready_stagger_total_s": 0.0,  # OR: whole fleet up over this span
                                   # (scale-invariant — 200 replicas
                                   # come up as fast as 20)
    "brownout_depth": 48,        # per-replica governor depth_high
    "alert_ttft_ms": 0.0,        # replica beats alert when recent TTFT
    "alert_window_s": 10.0,      # p95 over this window exceeds it
}

DEFAULT_ROUTER = {
    "act": True,
    "steer_clear_sweeps": 3,
    "affinity_slack": 4,
    "affinity_prefix": 32,
    "stale_s": 10.0,
    "sweep_s": 1.0,
    "snapshot_s": 5.0,
    "dispatch_timeout_s": 8.0,
    "retry_s": 0.25,
    "probe_limit": 8,            # queue-full probes per attempt before
                                 # backing off (bounds the herd's
                                 # probe storm at fleet scale)
    "max_replicas": 0,           # >base → scale governor armed
}

DEFAULT_SLO = {
    "ttft_p99_ms": 0.0,
    "reject_rate": 0.0,
    "availability": 0.0,
    "fast_s": 10.0,
    "slow_s": 40.0,
    "min_count": 20,
}

SCENARIOS: dict[str, dict] = {
    # Thundering-herd cold start: the whole day's traffic spike lands
    # while the fleet is still coming up one replica at a time. The
    # queue lanes + brownout must shed batch work, keep interactive
    # flowing, raise the reject-rate alert — and clear it once the
    # fleet is warm.
    "herd": {
        "name": "herd",
        "replicas": 24,
        "duration_s": 180.0,
        "requests": 24_000,
        "seed": 17,
        "arrival": [[0.0, 0.15, 10.0], [0.15, 1.0, 1.0]],
        "tenants": [
            {"tenant": "web", "share": 0.7,
             "sla_class": CLASS_INTERACTIVE,
             "prompt_len": [16, 96], "max_new": 24,
             "deadline_s": 30.0, "sessions": 400, "prompts": 0},
            {"tenant": "crawler", "share": 0.3, "sla_class": CLASS_BATCH,
             "prompt_len": [128, 384], "max_new": 48,
             "deadline_s": 45.0, "sessions": 0, "prompts": 64},
        ],
        "fleet": {"ready_stagger_total_s": 36.0, "brownout_depth": 24},
        "router": {},
        "slo": {"reject_rate": 0.10, "availability": 0.5},
        "faults": [],
        "assert": {
            "completed_rate": {"min": 0.60},
            "shed_rate": {"max": 0.40},
            "interactive_shed": {"max": 0},
            "alerts_raised": {"min": 1},
            "alerts_cleared": {"min": 1},
            "duplicate_tokens": {"max": 0},
        },
    },
    # Regional failover: half the fleet dies at once mid-traffic and
    # restarts cold. In-flight streams must fail over with zero
    # duplicate tokens, the survivors absorb the load, and the dead
    # half readmits after restart.
    "failover": {
        "name": "failover",
        "replicas": 16,
        "duration_s": 180.0,
        "requests": 12_000,
        "seed": 23,
        "arrival": [[0.0, 1.0, 1.0]],
        "tenants": [
            {"tenant": "web", "share": 0.8,
             "sla_class": CLASS_INTERACTIVE,
             "prompt_len": [16, 64], "max_new": 24,
             "deadline_s": 30.0, "sessions": 300, "prompts": 0},
            {"tenant": "batch", "share": 0.2, "sla_class": CLASS_BATCH,
             "prompt_len": [64, 256], "max_new": 32,
             "deadline_s": 60.0, "sessions": 0, "prompts": 32},
        ],
        "fleet": {"restart_s": 25.0},
        "router": {},
        "slo": {"availability": 0.5},
        "faults": [{"t": 60.0, "kind": "kill", "replicas": "half"}],
        "assert": {
            "completed_rate": {"min": 0.80},
            "duplicate_tokens": {"max": 0},
            "ejections": {"min": 8},
            "readmits": {"min": 8},
            "failover_gap_p99_ms": {"max": 60_000.0},
            "interactive_ttft_p99_ms": {"max": 20_000.0},
        },
    },
    # Cache-cold restart storm: a rolling restart sweeps the whole
    # fleet; every replica comes back with a cold prefix cache (prefill
    # costs `cold_factor`× for `cold_s`). The fleet must stay available
    # throughout — every replica readmits, completions keep flowing.
    "restart_storm": {
        "name": "restart_storm",
        "replicas": 12,
        "duration_s": 240.0,
        "requests": 10_000,
        "seed": 31,
        "arrival": [[0.0, 1.0, 1.0]],
        "tenants": [
            {"tenant": "web", "share": 1.0,
             "sla_class": CLASS_INTERACTIVE,
             "prompt_len": [32, 128], "max_new": 24,
             "deadline_s": 45.0, "sessions": 200, "prompts": 0},
        ],
        "fleet": {"restart_s": 10.0, "cold_factor": 6.0, "cold_s": 30.0},
        "router": {},
        "slo": {"availability": 0.5},
        "faults": [{"t": 20.0 + 12.0 * i, "kind": "kill",
                    "replicas": [i]} for i in range(12)],
        "assert": {
            "completed_rate": {"min": 0.80},
            "ejections": {"min": 12},
            "readmits": {"min": 12},
            "duplicate_tokens": {"max": 0},
        },
    },
    # Adversarial tenant mix: a hostile batch tenant floods huge
    # prompts while a well-behaved interactive tenant keeps its small
    # requests coming. The class lanes + shed ladder must make the
    # batch tenant absorb ALL the shedding — interactive loses nothing.
    "adversarial": {
        "name": "adversarial",
        "replicas": 8,
        "duration_s": 120.0,
        "requests": 10_000,
        "seed": 41,
        "arrival": [[0.0, 1.0, 1.0]],
        "tenants": [
            {"tenant": "web", "share": 0.3,
             "sla_class": CLASS_INTERACTIVE,
             "prompt_len": [16, 48], "max_new": 16,
             "deadline_s": 20.0, "sessions": 150, "prompts": 0},
            {"tenant": "hostile", "share": 0.7, "sla_class": CLASS_BATCH,
             "prompt_len": [256, 512], "max_new": 64,
             "deadline_s": 8.0, "sessions": 0, "prompts": 16},
        ],
        "fleet": {"brownout_depth": 16},
        "router": {},
        "slo": {"reject_rate": 0.25},
        "faults": [],
        "assert": {
            "interactive_shed": {"max": 0},
            "shed": {"min": 1},
            "interactive_completed_rate": {"min": 0.90},
            "duplicate_tokens": {"max": 0},
        },
    },
    # Slow-burn degradation: one replica's decode quietly gets 8×
    # slower, burns its TTFT budget, gets steered, recovers, and is
    # readmitted to the latency tier. The hysteresis assertion is the
    # seeded-regression demo: with `--steer-clear-sweeps 1` the steer
    # rule oscillates (alert window drains while steered → unsteer →
    # traffic returns → burn again) and the reversal bound fires.
    "slow_burn": {
        "name": "slow_burn",
        "replicas": 6,
        "duration_s": 240.0,
        "requests": 9_000,
        "seed": 53,
        "arrival": [[0.0, 1.0, 1.0]],
        "tenants": [
            {"tenant": "web", "share": 0.8,
             "sla_class": CLASS_INTERACTIVE,
             "prompt_len": [16, 64], "max_new": 24,
             "deadline_s": 60.0, "sessions": 200, "prompts": 0},
            {"tenant": "batch", "share": 0.2, "sla_class": CLASS_BATCH,
             "prompt_len": [64, 128], "max_new": 24,
             "deadline_s": 90.0, "sessions": 0, "prompts": 16},
        ],
        "fleet": {"alert_ttft_ms": 900.0, "alert_window_s": 8.0},
        "router": {"steer_clear_sweeps": 6},
        "slo": {},
        "faults": [
            {"t": 40.0, "kind": "degrade", "replicas": [2],
             "factor": 8.0},
            {"t": 160.0, "kind": "recover", "replicas": [2]},
        ],
        "assert": {
            "steers": {"min": 1},
            "steer_reversals": {"max": 2},
            "completed_rate": {"min": 0.90},
            "duplicate_tokens": {"max": 0},
        },
    },
}

# Canonical report vocabulary (see report()); bench + obs diff key off
# this tuple, so adding a key here is a schema change the diff-gate
# guard (scripts/check_diff_gates.py) will notice.
REPORT_KEYS = (
    "requests", "completed", "completed_rate",
    "interactive_completed_rate",
    "shed", "shed_rate", "interactive_shed",
    "reject_rate", "timeout_rate",
    "ttft_p99_ms", "interactive_ttft_p99_ms",
    "failover_gap_p99_ms", "duplicate_tokens",
    "alerts_raised", "alerts_cleared", "fleet_alerts_raised",
    "steers", "steer_reversals", "ejections", "readmits",
    "scale_up", "scale_down", "dispatched", "redispatched",
)

# The subset obs diff gates per pinned bench scenario (bench.py
# fleet_sim probe): key name in diff = sim_<scenario>_<key>, except a
# key already carrying the scenario prefix collapses (failover's
# failover_gap_p99_ms gates as sim_failover_gap_p99_ms).
DIFF_GATED = {
    "herd": ("shed_rate", "completed_rate", "interactive_ttft_p99_ms",
             "alerts_raised", "duplicate_tokens"),
    "failover": ("completed_rate", "interactive_ttft_p99_ms",
                 "failover_gap_p99_ms", "steer_reversals",
                 "duplicate_tokens"),
}


def diff_key(scenario: str, key: str) -> str:
    return (f"sim_{key}" if key.startswith(scenario + "_")
            else f"sim_{scenario}_{key}")


def _merged(scn: dict) -> dict:
    """Scenario with section defaults filled in (pure data in, pure
    data out — the copy is what run() mutates with CLI overrides)."""
    out = dict(scn)
    out["fleet"] = {**DEFAULT_FLEET, **scn.get("fleet", {})}
    out["router"] = {**DEFAULT_ROUTER, **scn.get("router", {})}
    out["slo"] = {**DEFAULT_SLO, **scn.get("slo", {})}
    out["faults"] = [dict(f) for f in scn.get("faults", [])]
    out["assert"] = dict(scn.get("assert", {}))
    return out


# ------------------------------------------------------------ simulator


class _SimReplica:
    """The modeled half of one replica: a REAL AdmissionQueue + REAL
    BrownoutGovernor + slots, driven by the synthetic timing model. The
    policy-visible half is the REAL ReplicaHandle state machine."""

    __slots__ = ("handle", "queue", "gov", "n_slots", "free", "alive",
                 "ready_at", "restarted_at", "factor", "brownout",
                 "forced_brownout", "recent_ttft", "pending", "full",
                 "last_shed_t")

    def __init__(self, handle: ReplicaHandle, fleet_cfg: dict,
                 clock, ready_at: float):
        self.handle = handle
        self.n_slots = int(fleet_cfg["n_slots"])
        self.free = self.n_slots
        self.alive = True
        self.ready_at = ready_at          # first serve-phase beat
        self.restarted_at: float | None = None
        self.factor = 1.0                 # degradation multiplier
        self.brownout = False             # own governor entered
        self.forced_brownout = False      # router-ordered class brownout
        self.full = False                 # last submit saw queue_full
        self.last_shed_t = -1.0           # last doom-shed scan (mono)
        self.recent_ttft: deque = deque()  # (t_mono, ttft_ms)
        self.pending: set[str] = set()    # rids queued or in a slot
        self._fresh_engine(fleet_cfg, clock)

    def _fresh_engine(self, fleet_cfg: dict, clock) -> None:
        """A (re)started replica process: empty queue, reset governor —
        exactly what a real engine restart gives you."""
        self.queue = AdmissionQueue(
            int(fleet_cfg["queue_capacity"]),
            max_total_tokens=int(fleet_cfg["max_total_tokens"]),
            prefill_budget=int(fleet_cfg["prefill_budget"]),
            clock=clock)
        self.gov = BrownoutGovernor(
            depth_high=int(fleet_cfg["brownout_depth"]))
        self.free = self.n_slots
        self.brownout = False
        self.recent_ttft.clear()
        self.pending = set()


class _SimRequest:
    __slots__ = ("rid", "req", "doc", "tenant", "born", "replica",
                 "epoch", "exclude", "route_deadline", "fail_at",
                 "redispatches", "delivered", "client_first",
                 "resolved", "retry_s")

    def __init__(self, rid, req, doc, tenant, born, route_deadline):
        self.rid = rid
        self.req = req
        self.doc = doc
        self.tenant = tenant
        self.born = born                 # arrival (client submit), mono
        self.replica: int | None = None
        self.epoch = 0                   # bumps on failover: stale
        self.exclude: set[int] = set()   # first/fin events are ignored
        self.route_deadline = route_deadline
        self.fail_at: float | None = None
        self.redispatches = 0
        self.delivered = 0               # tokens forwarded to client
        self.client_first: float | None = None
        self.resolved = False
        self.retry_s = 0.0               # current dispatch backoff


class FleetSimulator:
    """One scenario played to completion on a virtual clock."""

    def __init__(self, scenario: dict, out_dir: str | Path, *,
                 mono0: float = MONO0, wall0: float = WALL0):
        self.scn = scn = _merged(scenario)
        self.out = Path(out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.clk = VirtualClock(mono0, wall0=wall0)
        self.run_id = f"sim_{scn['name']}"
        self.reg = MetricsRegistry(clock=self.clk)
        self.smetrics = ServeMetrics(registry=self.reg, clock=self.clk)
        self.rmetrics = RouterMetrics(registry=self.reg)
        self.tracer = Tracer(self.out / "telemetry.jsonl",
                             run=self.run_id, proc=0,
                             clock=self.clk, wall=self.clk.wall)
        self.hb = Heartbeat(self.out / "heartbeat.json", run=self.run_id,
                            proc=0, every=1, clock=self.clk,
                            wall=self.clk.wall)
        rt = scn["router"]
        n = int(scn["replicas"])
        handles = [ReplicaHandle.under(self.out, i) for i in range(n)]
        self.policy = RouterPolicy(
            handles,
            affinity_slack=int(rt["affinity_slack"]),
            prefix_tokens=int(rt["affinity_prefix"]),
            clock=self.clk)
        total_stagger = float(scn["fleet"]["ready_stagger_total_s"])
        stagger = (total_stagger / max(1, n) if total_stagger > 0
                   else float(scn["fleet"]["ready_stagger_s"]))
        self.fleet = [
            _SimReplica(h, scn["fleet"], self.clk,
                        self.clk() + i * stagger)
            for i, h in enumerate(handles)]
        self.max_replicas = int(rt["max_replicas"] or 0)
        scale_gov = (BrownoutGovernor(depth_high=1)
                     if rt["act"] and self.max_replicas > n else None)
        # THE tentpole join: the same FleetActions object the live
        # Router drives, with synthetic side effects wired in
        self.actions = FleetActions(
            self.policy, self.rmetrics, self.tracer,
            act=bool(rt["act"]),
            steer_clear_sweeps=int(rt["steer_clear_sweeps"]),
            scale_gov=scale_gov,
            order_brownout=self._order_brownout,
            scale_up=self._scale_up, scale_down=self._scale_down)
        slo = scn["slo"]
        targets = slo_mod.standard_targets(
            ttft_p99_ms=float(slo["ttft_p99_ms"]),
            reject_rate=float(slo["reject_rate"]),
            availability=float(slo["availability"]),
            min_count=int(slo["min_count"]))
        self.slo = (slo_mod.SLOMonitor(
            targets, self.reg, fast_s=float(slo["fast_s"]),
            slow_s=float(slo["slow_s"]),
            eval_every_s=2.0 * float(rt["sweep_s"]), clock=self.clk)
            if targets else None)
        # hot-path scalars, hoisted out of the per-event dict walks
        fl = scn["fleet"]
        self._prefill_ms = float(fl["prefill_ms_per_token"])
        self._decode_ms = float(fl["decode_ms_per_token"])
        self._cold_factor = float(fl["cold_factor"])
        self._cold_s = float(fl["cold_s"])
        self._restart_s = float(fl["restart_s"])
        self._retry0 = float(rt["retry_s"])
        self._dispatch_timeout_s = float(rt["dispatch_timeout_s"])
        self._probe_limit = max(1, int(rt["probe_limit"]))
        self._alert_ttft_ms = float(fl["alert_ttft_ms"])
        self._alert_window_s = float(fl["alert_window_s"])
        # in-memory heartbeat transport: the seam that replaces disk
        self.hb_store: dict = {}
        self.heap: list = []
        self._seq = itertools.count()
        self.requests: dict[str, _SimRequest] = {}
        self.unresolved = 0
        self.n_requests = int(scn["requests"])
        self.sample_every = max(1, self.n_requests // 2000)
        self._emitted = 0
        self._last_snap = self.clk()
        self._dup = self.reg.counter("sim_duplicate_tokens")
        self._client_ttft = self.reg.histogram("sim_client_ttft_ms")
        self._client_ttft_by_cls = {
            c: self.reg.histogram(f"sim_client_ttft_{c}_ms")
            for c in (CLASS_INTERACTIVE, CLASS_BATCH)}
        # saturation fast-path: a replica whose last submit returned
        # queue_full is flagged until ITS queue frees a position, and
        # flagged replicas are pre-excluded from choose() — the same
        # dispatch outcome the live router reaches by probing each full
        # queue over a socket and rerouting on the reject, minus the
        # wasted probes (at fleet scale the probe storm is what melts
        # the sim's wall-clock). While every ready replica is flagged,
        # arrivals/retries skip straight to backoff. `_nready_est` is
        # refreshed each sweep; staleness only wastes a few probes.
        self._full_idx: set[int] = set()
        self._nready_est = 0

    # ------------------------------------------------------- event heap

    def _push(self, t: float, kind: str, arg) -> None:
        heapq.heappush(self.heap, (t, next(self._seq), kind, arg))

    # -------------------------------------------------------- lifecycle

    def _build_workload(self) -> None:
        scn = self.scn
        rng = np.random.default_rng(int(scn["seed"]))
        n, dur = self.n_requests, float(scn["duration_s"])
        segs = scn["arrival"]
        w = np.array([(b - a) * max(0.0, float(wt)) for a, b, wt in segs])
        counts = rng.multinomial(n, w / w.sum())
        ts = np.concatenate([
            rng.uniform(a * dur, b * dur, c)
            for (a, b, _), c in zip(segs, counts)])
        ts.sort()
        tenants = scn["tenants"]
        shares = np.array([float(t["share"]) for t in tenants])
        t_idx = rng.choice(len(tenants), n, p=shares / shares.sum())
        # pooled prompt arrays: shared (never mutated) so a million
        # requests do not allocate a million arrays, and so pooled
        # prompts give prefix affinity something real to key on
        pools = []
        for t in tenants:
            lo, hi = t["prompt_len"]
            n_pool = max(1, int(t.get("prompts") or 0) or 512)
            lens = rng.integers(int(lo), int(hi) + 1, n_pool)
            pools.append([np.arange(m, dtype=np.int32) + 7 * p
                          for p, m in enumerate(lens)])
        pool_pick = rng.integers(0, 1 << 30, n)
        sess_pick = rng.integers(0, 1 << 30, n)
        for i in range(n):
            tn = tenants[t_idx[i]]
            ids = pools[t_idx[i]][pool_pick[i] % len(pools[t_idx[i]])]
            sessions = int(tn.get("sessions") or 0)
            doc: dict = {"class": tn["sla_class"]}
            if sessions > 0:
                doc["session_id"] = (
                    f"{tn['tenant']}-{sess_pick[i] % sessions}")
            elif int(tn.get("prompts") or 0) > 0:
                doc["prompt_ids"] = ids.tolist()
            req = Request(
                prompt_ids=ids, max_new_tokens=int(tn["max_new"]),
                id=f"sim{i}", sla_class=tn["sla_class"],
                tenant=tn["tenant"],
                deadline_s=float(tn["deadline_s"]) or None)
            self._push(self.clk() + float(ts[i]), "arrive",
                       (req, doc, tn["tenant"]))
        self.unresolved = n
        for f in scn["faults"]:
            self._push(self.clk() + float(f["t"]), "fault", f)
        self._push(self.clk() + float(scn["router"]["sweep_s"]),
                   "sweep", None)

    def run(self) -> dict:
        t_start_wall = time.perf_counter()
        scn = self.scn
        self.tracer.event(
            "router_start", replicas=len(self.policy.replicas),
            slots=int(scn["fleet"]["n_slots"]),
            stale_s=float(scn["router"]["stale_s"]),
            affinity_prefix=int(scn["router"]["affinity_prefix"]))
        self.tracer.event(
            "sim_scenario", scenario=scn["name"],
            replicas=int(scn["replicas"]), requests=self.n_requests,
            duration_s=float(scn["duration_s"]),
            seed=int(scn["seed"]), faults=len(scn["faults"]))
        self.hb.pulse(phase="route_spawn", ready=0)
        self._build_workload()
        self._sweep()  # first beats land before the first arrival
        hard_end = self.clk() + float(scn["duration_s"]) * 4 + 600.0
        while self.heap:
            t, _, kind, arg = heapq.heappop(self.heap)
            if t > hard_end:
                break
            self.clk.advance_to(t)
            if kind == "arrive":
                self._arrive(*arg)
            elif kind == "first":
                self._first_token(*arg)
            elif kind == "fin":
                self._finish(*arg)
            elif kind == "retry":
                self._retry(arg)
            elif kind == "sweep":
                self._sweep()
                if self.unresolved > 0:
                    self._push(self.clk()
                               + float(scn["router"]["sweep_s"]),
                               "sweep", None)
            elif kind == "ready":
                self._replica_up(arg)
            elif kind == "fault":
                self._fault(arg)
        self.tracer.snapshot(self.reg)
        report = self.report()
        asserts = self.evaluate_asserts(report)
        self.tracer.event(
            "sim_report", scenario=scn["name"],
            ok=all(a["ok"] for a in asserts), checks=len(asserts),
            failed=sum(1 for a in asserts if not a["ok"]),
            failed_checks=[
                f"{a['key']} {a['op']} {a['limit']} (got {a['value']})"
                for a in asserts if not a["ok"]],
            report={k: report[k] for k in REPORT_KEYS})
        summary = self.rmetrics.summary()
        self.tracer.event("router_end", **summary)
        self.hb.close(phase="done", dispatched=summary["dispatched"],
                      completed=summary["completed"])
        self.tracer.close()
        return {
            "scenario": scn["name"],
            "replicas": int(scn["replicas"]),
            "requests": self.n_requests,
            "virtual_s": round(self.clk() - MONO0, 3),
            "wall_s": round(time.perf_counter() - t_start_wall, 3),
            "dir": str(self.out),
            "report": report,
            "asserts": asserts,
            "ok": all(a["ok"] for a in asserts),
        }

    # ------------------------------------------------------- dispatch

    def _sampled(self) -> bool:
        self._emitted += 1
        return self._emitted % self.sample_every == 0

    def _arrive(self, req: Request, doc: dict, tenant: str) -> None:
        now = self.clk()
        sr = _SimRequest(req.id, req, doc, tenant, now,
                         now + self._dispatch_timeout_s)
        self.requests[req.id] = sr
        self._route(sr)

    def _route(self, sr: _SimRequest) -> None:
        """Mirror of Router._relay_inner's dispatch loop on the event
        heap: choose → submit; queue_full excludes and retries the
        next-best; nothing ready → backoff retry until the dispatch
        deadline rejects."""
        now = self.clk()
        qfull_probes = 0
        full = self._full_idx
        saturated = 0 < self._nready_est <= len(full)
        while True:
            rep = None
            if not saturated and qfull_probes < self._probe_limit:
                excl = (frozenset(sr.exclude | full) if full
                        else frozenset(sr.exclude))
                rep, meta = self.policy.choose(sr.doc, excl)
            if rep is None:
                if now > sr.route_deadline:
                    reason = (REJECT_QUEUE_FULL
                              if sr.exclude or saturated or full
                              else REJECT_NO_REPLICA)
                    self._reject(sr, reason, router=True)
                    return
                # exponential backoff: a herd of rejected requests
                # polling a saturated fleet every tick would melt the
                # event loop exactly like it melts a real router
                sr.retry_s = min(4.0, max(self._retry0, sr.retry_s * 2))
                self._push(now + sr.retry_s, "retry", sr.rid)
                return
            sim = self.fleet[rep.index]
            ok, reason = sim.queue.submit(sr.req)
            if not ok:
                self.policy.release(rep)
                if reason == REJECT_QUEUE_FULL:
                    qfull_probes += 1
                    sr.exclude.add(rep.index)
                    if not sim.full:
                        sim.full = True
                        full.add(rep.index)
                        saturated = (0 < self._nready_est
                                     <= len(full))
                    self.rmetrics.on_redispatch(REJECT_QUEUE_FULL)
                    if self._sampled():
                        self.tracer.event(
                            "route_redispatch", request=sr.rid,
                            from_replica=rep.index, reason=reason,
                            delivered=sr.delivered)
                    continue
                self._reject(sr, reason, router=False)
                return
            self.smetrics.on_accept(sr.req.sla_class)
            self.rmetrics.on_dispatch(rep.index, meta["affinity_hit"],
                                      meta["had_key"])
            sr.replica = rep.index
            sim.pending.add(sr.rid)
            if self._sampled():
                self.tracer.event(
                    "route_dispatch", request=sr.rid, replica=rep.index,
                    affinity=meta["affinity_hit"],
                    redispatch=sr.redispatches,
                    tenant=sr.tenant, sla_class=sr.req.sla_class)
                self.tracer.event(
                    "request_admitted", request=sr.rid,
                    prompt_len=sr.req.prompt_len,
                    max_new_tokens=sr.req.max_new_tokens,
                    sla_class=sr.req.sla_class, tenant=sr.tenant)
            self._pump(rep.index)
            return

    def _unfull(self, sim: _SimReplica) -> None:
        if sim.full:
            sim.full = False
            self._full_idx.discard(sim.handle.index)

    def _retry(self, rid: str) -> None:
        sr = self.requests.get(rid)
        if sr is not None and not sr.resolved and sr.replica is None:
            self._route(sr)

    # -------------------------------------------------- replica engine

    def _pump(self, ridx: int) -> None:
        """One synthetic engine tick: governor, shed ladder, admission
        into free slots — all real queue policy."""
        sim = self.fleet[ridx]
        if not sim.alive or sim.handle.state != READY:
            return
        now = self.clk()
        tr = sim.gov.update(sim.queue.depth)
        if tr == "enter":
            sim.brownout = True
            self._set_brownout_gauge()
            self.tracer.event("brownout_enter", replica=ridx,
                              depth=sim.queue.depth,
                              wait_p95_ms=round(
                                  sim.gov.wait_p95() * 1e3, 3))
        elif tr == "exit":
            sim.brownout = False
            self._set_brownout_gauge()
            self.tracer.event("brownout_exit", replica=ridx,
                              depth=sim.queue.depth)
        if (sim.brownout or sim.forced_brownout) \
                and now - sim.last_shed_t >= 0.2:
            sim.last_shed_t = now
            # class-ordered shed ladder: batch first, interactive only
            # while batch is already empty (engine.py's ladder); the
            # wait estimate is the governor's OBSERVED admission-wait
            # p95 — the same evidence the live engine sheds on — with a
            # queue-model floor for the cold start before observations
            est = max(sim.gov.wait_p95(),
                      sim.queue.depth / max(1, sim.n_slots)
                      * self._decode_ms * 1e-3 * 8)
            classes = ((CLASS_BATCH,)
                       if sim.queue.depth_of(CLASS_BATCH) else None)
            for r in sim.queue.shed_doomed(now=now, est_wait_s=est,
                                           classes=classes):
                self._unfull(sim)
                self._resolve_shed(sim, r)
        while sim.free > 0:
            admit, expired = sim.queue.pop_ready(sim.free, now=now)
            if admit or expired:
                self._unfull(sim)
            for r in expired:
                self._resolve_timeout(sim, r)
            if not admit:
                break
            for r in admit:
                sr = self.requests[r.id]
                r.admitted_at = now
                r.queue_wait_s = now - r.enqueued_at
                sim.gov.observe_wait(r.queue_wait_s, r.sla_class)
                sim.free -= 1
                cold = 1.0
                if (sim.restarted_at is not None
                        and now - sim.restarted_at < self._cold_s):
                    cold = self._cold_factor
                prefill_s = (r.prompt_len * self._prefill_ms
                             * sim.factor * cold * 1e-3)
                self._push(now + prefill_s, "first", (r.id, sr.epoch))

    def _first_token(self, rid: str, epoch: int) -> None:
        sr = self.requests[rid]
        if sr.resolved or epoch != sr.epoch:
            return
        now = self.clk()
        sim = self.fleet[sr.replica]
        req = sr.req
        req.first_token_at = now
        self.smetrics.on_first_token(req, now=now)
        ttft_ms = (now - req.submitted_at) * 1e3
        sim.recent_ttft.append((now, ttft_ms))
        if sr.client_first is None:
            # client-observed TTFT: survives failover restamps — the
            # number the failover scenario asserts on
            sr.client_first = now
            ms = (now - sr.born) * 1e3
            self._client_ttft.observe(ms)
            self._client_ttft_by_cls[req.sla_class].observe(ms)
        if sr.fail_at is not None:
            self.rmetrics.on_failover_gap(now - sr.fail_at)
            sr.fail_at = None
        decode_s = (max(0, req.max_new_tokens - 1)
                    * self._decode_ms * sim.factor * 1e-3)
        self._push(now + decode_s, "fin", (rid, sr.epoch))

    def _finish(self, rid: str, epoch: int) -> None:
        sr = self.requests[rid]
        if sr.resolved or epoch != sr.epoch:
            return
        now = self.clk()
        sim = self.fleet[sr.replica]
        req = sr.req
        req.finished_at = now
        req.status = "done"
        req.finish_reason = "budget"
        if sr.redispatches:
            self._audit_replay(sr)
        sr.delivered = req.max_new_tokens
        self.smetrics.on_finish(req, now=now)
        self.smetrics.count_tokens(req.max_new_tokens)
        self.rmetrics.on_complete()
        if self._sampled():
            # phase/tpot histograms ride the same sampling as the
            # per-request events: representative shape, bounded cost
            self.smetrics.on_phases(req)
            self.smetrics.on_token_gap(
                self._decode_ms * sim.factor * 1e-3, req.sla_class)
            self.tracer.event(
                "route_complete", request=rid, replica=sr.replica,
                status="completed", tokens=req.max_new_tokens,
                redispatches=sr.redispatches,
                e2e_s=round(now - sr.born, 6))
        self._release(sim, sr, slot=True)

    def _audit_replay(self, sr: _SimRequest) -> None:
        """Exactly-once audit through the REAL StreamDedup: reconstruct
        the dedup state the router held at failover, then replay the
        replacement replica's full stream — any token it would forward
        twice lands on the zero-pinned sim_duplicate_tokens counter."""
        dedup = StreamDedup()
        for i in range(sr.delivered):
            dedup.admit({"event": "token", "i": i})
        before = sr.delivered
        dupes = 0
        for i in range(sr.req.max_new_tokens):
            if dedup.admit({"event": "token", "i": i}) and i < before:
                dupes += 1
        if dupes:
            self._dup.inc(dupes)

    # ------------------------------------------------------ resolution

    def _release(self, sim: _SimReplica, sr: _SimRequest, *,
                 slot: bool) -> None:
        sr.resolved = True
        self.unresolved -= 1
        sim.pending.discard(sr.rid)
        self.policy.release(sim.handle)
        if slot:
            sim.free += 1
        self._pump(sim.handle.index)

    def _reject(self, sr: _SimRequest, reason: str, *,
                router: bool) -> None:
        sr.resolved = True
        self.unresolved -= 1
        sr.req.status = "rejected"
        self.smetrics.on_reject(reason)
        if router:
            self.rmetrics.on_reject(reason)
        if self._sampled():
            self.tracer.event("request_rejected", request=sr.rid,
                              reason=reason, sla_class=sr.req.sla_class,
                              tenant=sr.tenant, queued_s=0.0)

    def _resolve_shed(self, sim: _SimReplica, req: Request) -> None:
        sr = self.requests[req.id]
        sr.resolved = True
        self.unresolved -= 1
        sim.pending.discard(req.id)
        self.policy.release(sim.handle)
        self.smetrics.on_shed(req.sla_class)
        self.smetrics.on_reject(REJECT_SHED)
        if self._sampled():
            self.tracer.event("request_rejected", request=req.id,
                              reason=REJECT_SHED, shed=True,
                              sla_class=req.sla_class, tenant=sr.tenant,
                              queued_s=round(
                                  self.clk() - req.enqueued_at, 6))

    def _resolve_timeout(self, sim: _SimReplica, req: Request) -> None:
        sr = self.requests[req.id]
        sr.resolved = True
        self.unresolved -= 1
        sim.pending.discard(req.id)
        self.policy.release(sim.handle)
        self.smetrics.on_timeout()

    # ---------------------------------------------------------- faults

    def _fault(self, f: dict) -> None:
        kind = f.get("kind")
        targets = f.get("replicas")
        base = [s for s in self.fleet if not s.handle.standby]
        if targets == "half":
            idxs = [s.handle.index for s in base[:len(base) // 2]]
        elif isinstance(targets, int):
            idxs = [s.handle.index for s in base[:targets]]
        else:
            idxs = [int(i) for i in (targets or [])]
        for i in idxs:
            if i >= len(self.fleet):
                continue
            sim = self.fleet[i]
            if kind == "kill":
                self._kill(sim)
            elif kind == "degrade":
                sim.factor = float(f.get("factor", 4.0))
            elif kind == "recover":
                sim.factor = 1.0

    def _kill(self, sim: _SimReplica) -> None:
        """A replica process dies: its queue dies with it, every
        dispatched-but-unfinished stream fails over (real eject + real
        re-dispatch + real dedup floors)."""
        if not sim.alive:
            return
        now, wall = self.clk(), self.clk.wall()
        sim.alive = False
        self._unfull(sim)  # out of the dispatch set, out of the tally
        ridx = sim.handle.index
        if self.policy.eject(sim.handle, "connection error (sim kill)",
                             now=wall):
            self.rmetrics.on_eject()
            self.tracer.event("replica_ejected", replica=ridx,
                              reason="connection error (sim kill)")
        affected = [self.requests[rid] for rid in sorted(sim.pending)]
        fl = self.scn["fleet"]
        for sr in affected:
            # the router's relay sees the connection drop: release the
            # dead replica, note delivered tokens, re-dispatch
            self.policy.release(sim.handle)
            req = sr.req
            if req.first_token_at:
                per_tok = self._decode_ms * sim.factor * 1e-3
                sr.delivered = min(
                    req.max_new_tokens,
                    1 + int((now - req.first_token_at)
                            / max(per_tok, 1e-9)))
            sr.epoch += 1
            sr.redispatches += 1
            sr.fail_at = now
            sr.replica = None
            sr.exclude.add(ridx)
            sr.route_deadline = now + float(
                self.scn["router"]["dispatch_timeout_s"])
            req.first_token_at = None
            req.admitted_at = None
            req.status = "queued"
            self.rmetrics.on_redispatch("replica_lost")
            if self._sampled():
                self.tracer.event("route_redispatch", request=sr.rid,
                                  from_replica=ridx,
                                  reason="replica_lost",
                                  delivered=sr.delivered)
        sim.pending = set()
        # heartbeats stop (the stale entry stays in the store, exactly
        # like a dead process's last file on disk); restart_s later the
        # process is back with a cold, empty engine
        self._push(now + float(fl["restart_s"]), "ready", ridx)
        for sr in affected:
            self._route(sr)

    def _replica_up(self, ridx: int) -> None:
        sim = self.fleet[ridx]
        if sim.handle.retiring:
            return
        sim.alive = True
        sim.restarted_at = self.clk()
        sim.handle.restarts += 1
        sim._fresh_engine(self.scn["fleet"], self.clk)
        # readmission happens on the next sweep's fresh serve beat —
        # through the REAL ReplicaHandle.observe_beat path

    # ----------------------------------------------------- router loop

    def _alerts(self, sim: _SimReplica) -> list[str]:
        """Synthesized replica-side SLO alert: the engine's own burn
        monitor reduced to its observable — 'my recent TTFT p95 blew
        the budget'. Entries age out of the window, so a steered
        (idle) replica goes quiet and the steer hysteresis is the only
        thing standing between recovery and a flap."""
        budget = self._alert_ttft_ms
        if budget <= 0:
            return []
        now = self.clk()
        win = self._alert_window_s
        rt = sim.recent_ttft
        while rt and rt[0][0] < now - win:
            rt.popleft()
        if len(rt) >= 3 and percentile([m for _, m in rt], 95) > budget:
            return ["ttft_p99"]
        return []

    def _sweep(self) -> None:
        """The monitor loop's one iteration, on virtual time: heartbeat
        refresh, readiness transitions, fleet alerts, the FleetActions
        steer/scale sweep, SLO evaluation, exposition."""
        now, wall = self.clk(), self.clk.wall()
        scn = self.scn
        for sim in self.fleet:
            if sim.alive and now >= sim.ready_at:
                self.hb_store[sim.handle.heartbeat_path] = {
                    "run": self.run_id, "pid": 4242 + sim.handle.index,
                    "phase": "serve", "t_wall": wall,
                    "active": sim.n_slots - sim.free,
                    "queue": sim.queue.depth,
                    "alerts": self._alerts(sim),
                }
        transitions = self.policy.observe_beats(
            self.hb_store.get, now=wall,
            stale_s=float(scn["router"]["stale_s"]))
        for tr in transitions:
            if tr[0] in ("ready", "readmitted"):
                rep = tr[1]
                self._unfull(self.fleet[rep.index])
                if tr[0] == "readmitted":
                    self.rmetrics.on_readmit()
                self.tracer.event(f"replica_{tr[0]}", replica=rep.index,
                                  restarts=rep.restarts)
                self._pump(rep.index)
            else:
                _, rep, reason = tr
                self.rmetrics.on_eject()
                self.tracer.event("replica_ejected", replica=rep.index,
                                  reason=reason)
        fleet_alerts = self.actions.sweep_alerts()
        self.actions.sweep()
        ready = self.policy.ready_count
        self._nready_est = ready
        inflight = self.policy.inflight_total
        self.rmetrics.observe_fleet(ready, inflight,
                                    alerts_active=len(fleet_alerts))
        total_q = sum(s.queue.depth for s in self.fleet)
        busy = sum(s.n_slots - s.free for s in self.fleet)
        slots = sum(s.n_slots for s in self.fleet)
        self.smetrics.observe_state(total_q, busy, max(1, slots))
        for sim in self.fleet:
            if sim.alive and sim.handle.state == READY:
                for r in sim.queue.drop_expired(now=now):
                    self._unfull(sim)
                    self._resolve_timeout(sim, r)
                self._pump(sim.handle.index)
        if self.slo is not None:
            trs = self.slo.evaluate()
            if trs:
                slo_mod.publish(trs, self.tracer, self.reg,
                                prefix="serve",
                                active=len(self.slo.active))
        self.hb.beat(step=int(self.reg.counter("route_dispatched").value),
                     phase="route", active=inflight, queue=total_q,
                     ready=ready, alerts=fleet_alerts)
        if now - self._last_snap >= float(scn["router"]["snapshot_s"]):
            self.tracer.snapshot(self.reg)
            self._last_snap = now

    # ------------------------------------------------- acting callbacks

    def _set_brownout_gauge(self) -> None:
        n = sum(1 for s in self.fleet
                if s.brownout or s.forced_brownout)
        self.smetrics.set_brownout(n > 0)

    def _order_brownout(self, rep: ReplicaHandle, active: bool) -> None:
        """The simulator's control-socket stand-in: the order always
        reaches its replica (transport is perfect here — the policy
        under test is WHEN to order, not whether UDP-over-unix
        works)."""
        sim = self.fleet[rep.index]
        sim.forced_brownout = bool(active)
        self._set_brownout_gauge()
        self.rmetrics.on_class_brownout(active)
        self.tracer.event("class_brownout", replica=rep.index,
                          active=active, acked=True)

    def _scale_up(self) -> None:
        idx = len(self.policy.replicas)
        if self.max_replicas and idx >= self.max_replicas:
            return
        handle = ReplicaHandle.under(self.out, idx)
        handle.standby = True
        sim = _SimReplica(handle, self.scn["fleet"], self.clk,
                          self.clk()
                          + float(self.scn["fleet"]["restart_s"]))
        self.fleet.append(sim)
        self.policy.add_replica(handle)
        self.rmetrics.on_scale(True)
        self.tracer.event("router_scale", direction="up", replica=idx,
                          fleet=len(self.policy.replicas))

    def _scale_down(self) -> None:
        handle = next((r for r in reversed(self.policy.replicas)
                       if r.standby and not r.retiring), None)
        if handle is None:
            return
        handle.retiring = True
        sim = self.fleet[handle.index]
        self._kill(sim)
        self.rmetrics.on_scale(False)
        self.tracer.event("router_scale", direction="down",
                          replica=handle.index,
                          fleet=sum(1 for r in self.policy.replicas
                                    if not r.retiring))

    # ---------------------------------------------------------- report

    def report(self) -> dict:
        """The exported headline metrics — every value read back off
        the registry/metric objects the policy code wrote, never off
        simulator-private state: what the obs plane can't see, a
        scenario can't assert."""
        c = lambda name: self.reg.counter(name).value  # noqa: E731
        n = max(1, self.n_requests)
        completed = c("serve_completed")
        rejected = c("serve_rejected")
        timed_out = c("serve_timed_out")
        inter_total = c("serve_accepted_interactive") or 1.0
        r = self.rmetrics.summary()

        def pct(h, p):
            v = h.percentile(p)
            return round(v, 3) if v == v else 0.0  # NaN on empty

        p99 = pct(self._client_ttft, 99)
        ip99 = pct(self._client_ttft_by_cls[CLASS_INTERACTIVE], 99)
        return {
            "requests": float(self.n_requests),
            "completed": completed,
            "completed_rate": round(completed / n, 6),
            "interactive_completed_rate": round(
                c("serve_completed_interactive") / inter_total, 6),
            "shed": c("serve_shed"),
            "shed_rate": round(c("serve_shed") / n, 6),
            "interactive_shed": c("serve_shed_interactive"),
            "reject_rate": round(rejected / n, 6),
            "timeout_rate": round(timed_out / n, 6),
            "ttft_p99_ms": p99,
            "interactive_ttft_p99_ms": ip99,
            "failover_gap_p99_ms": float(
                r.get("failover_gap_p99_ms") or 0.0),
            "duplicate_tokens": c("sim_duplicate_tokens"),
            "alerts_raised": c("serve_alerts_raised"),
            "alerts_cleared": c("serve_alerts_cleared"),
            "fleet_alerts_raised": float(r["fleet_alerts_raised"]),
            "steers": float(r["steers"]),
            "steer_reversals": float(r["unsteers"]),
            "ejections": float(r["ejections"]),
            "readmits": float(r["readmits"]),
            "scale_up": float(r["scale_up"]),
            "scale_down": float(r["scale_down"]),
            "dispatched": float(r["dispatched"]),
            "redispatched": float(r["redispatched"]),
        }

    def evaluate_asserts(self, report: dict) -> list[dict]:
        out = []
        for key, spec in sorted(self.scn["assert"].items()):
            value = report.get(key)
            for op, limit in sorted(spec.items()):
                ok = (value is not None
                      and (value <= limit if op == "max"
                           else value >= limit))
                out.append({"key": key, "op": op, "limit": limit,
                            "value": value, "ok": bool(ok)})
        return out


# ---------------------------------------------------------------- entry


def run_scenario(name_or_scn, **overrides) -> dict:
    """Programmatic entry: run a library scenario (by name) or an
    inline scenario dict. Overrides: replicas, requests, duration_s,
    seed, out (dir), plus dotted router/fleet keys via the `router` /
    `fleet` dict kwargs."""
    scn = (dict(SCENARIOS[name_or_scn])
           if isinstance(name_or_scn, str) else dict(name_or_scn))
    for k in ("replicas", "requests", "duration_s", "seed"):
        if overrides.get(k) is not None:
            scn[k] = overrides[k]
    for section in ("router", "fleet", "slo"):
        if overrides.get(section):
            scn[section] = {**scn.get(section, {}), **overrides[section]}
    out = overrides.get("out") or f"data/sim/{scn['name']}"
    return FleetSimulator(scn, out).run()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hyperion simulate",
        description="fleet flight simulator: play a scenario over the "
                    "real serving policy code on a virtual clock")
    p.add_argument("scenario", nargs="?", default=None,
                   help=f"one of: {', '.join(sorted(SCENARIOS))}")
    p.add_argument("--list", action="store_true",
                   help="list library scenarios and exit")
    p.add_argument("--replicas", type=int, default=None)
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--duration-s", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="telemetry dir (default data/sim/<scenario>)")
    p.add_argument("--steer-clear-sweeps", type=int, default=None,
                   help="override steer hysteresis (1 ≈ disabled — the "
                        "seeded-regression demo)")
    p.add_argument("--no-act", action="store_true",
                   help="observe-only router (no steer/scale)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--no-assert", action="store_true",
                   help="report metrics but never fail the exit code")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        for name in sorted(SCENARIOS):
            scn = SCENARIOS[name]
            print(f"{name:15s} replicas={scn['replicas']:<4d} "
                  f"requests={scn['requests']:<7d} "
                  f"duration={scn['duration_s']:.0f}s "
                  f"faults={len(scn.get('faults', []))} "
                  f"asserts={len(scn.get('assert', {}))}")
        return 0
    if not args.scenario:
        print("no scenario given (try --list)", file=sys.stderr)
        return 2
    if args.scenario not in SCENARIOS:
        print(f"unknown scenario {args.scenario!r} "
              f"(have: {', '.join(sorted(SCENARIOS))})", file=sys.stderr)
        return 2
    router_over: dict = {}
    if args.steer_clear_sweeps is not None:
        router_over["steer_clear_sweeps"] = args.steer_clear_sweeps
    if args.no_act:
        router_over["act"] = False
    res = run_scenario(
        args.scenario, replicas=args.replicas, requests=args.requests,
        duration_s=args.duration_s, seed=args.seed, out=args.out,
        router=router_over)
    if args.json:
        print(json.dumps(res, indent=2))
    else:
        rep = res["report"]
        print(f"[sim] {res['scenario']}: {res['requests']} requests / "
              f"{res['replicas']} replicas / {res['virtual_s']:.0f} "
              f"virtual s in {res['wall_s']:.2f}s wall "
              f"-> {res['dir']}")
        print(f"[sim] completed {rep['completed']:.0f} "
              f"({100 * rep['completed_rate']:.1f}%), shed "
              f"{rep['shed']:.0f}, interactive TTFT p99 "
              f"{rep['interactive_ttft_p99_ms']:.0f} ms, alerts "
              f"{rep['alerts_raised']:.0f} raised / "
              f"{rep['alerts_cleared']:.0f} cleared, steers "
              f"{rep['steers']:.0f}/{rep['steer_reversals']:.0f} "
              f"reversed, dup tokens {rep['duplicate_tokens']:.0f}")
        for a in res["asserts"]:
            mark = "ok " if a["ok"] else "FAIL"
            print(f"[sim]   {mark} {a['key']} {a['op']} {a['limit']} "
                  f"(got {a['value']})")
    if args.no_assert:
        return 0
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
