"""Replica-tier router — `hyperion_tpu/serve/router.py` in the port:

    python -m hyperion_tpu_torch.cli.main route --replicas N \\
        --ckpt model.npz [--device cuda|cpu] [--dtype bfloat16|float32]

One engine process is a good fleet citizen: continuous batching, radix
prefix reuse, per-request tracing, journal-replay crash safety. This
module is the layer that multiplies it — the front-end process that
turns "a server" into "a deployment":

  * **Fleet supervision** — N port `serve` children, each with its
    own unix socket, request journal, telemetry dir, and heartbeat,
    run under the shared supervisor core (`supervisor.py`) with
    per-replica restart budgets and the heartbeat hang watchdog.
    `--device` and `--dtype` pass through to every child (the card by
    default). The router itself imports no torch and never touches
    the card (all device work lives in the children), so it stays
    responsive while a child is wedged, and holds no CUDA context.
  * **Health-aware dispatch** — least-loaded scoring over each
    replica's heartbeat payload (active slots + queue depth, which the
    engine publishes on serve, idle, AND terminal beats) plus the
    dispatches the router has sent since that beat. A stale heartbeat,
    a beat showing the replica left the serve phases (draining/done),
    a connection error, or a child exit EJECTS the replica; it is
    readmitted only on a fresh serve-phase beat newer than the
    ejection (`serve/replica.py` is the state machine).
  * **Session/prefix affinity** — requests sharing a `session_id`, or
    a long common prompt prefix, route to the same replica so its
    RadixPrefixCache keeps hitting. Stickiness yields when the sticky
    target's load exceeds the least-loaded replica by more than the
    slack (a hot session must not melt one replica while others idle).
  * **Failover with exactly-once delivery** — every token record on
    the wire carries its stream index `i`. When a replica dies
    mid-stream the router re-dispatches the ORIGINAL request to
    another replica: sampling is seed-deterministic (PRNG keys fold the
    absolute position, never the wall clock), so the new replica
    recomputes the identical stream and the router forwards only the
    tokens the client has not seen. The dead replica's own journal
    replays the request sink-less on restart — visible on its
    telemetry as the resumed prefill the acceptance test asserts — so
    no completion is ever lost, and none is ever delivered twice.
  * **Backpressure composition** — a `queue_full` rejection from one
    replica triggers re-dispatch to the next-best; when EVERY ready
    replica says queue_full (or none is ready) past the dispatch
    deadline, the router rejects with the standard `request_rejected`
    vocabulary (`queue_full` / `no_replica`) on its own stream, so
    fleet-wide saturation lands in the same doctor/diff tables as
    single-engine backpressure.
  * **Acting on alerts** — the monitor does not just TALLY the
    SLO alerts replicas report on their heartbeats, it acts on them. A
    replica burning its TTFT budget is STEERED: interactive traffic
    routes around it while batch keeps flowing (protect the latency
    tier without starving the replica), and its engine is ordered into
    a batch-class brownout over the exposition control socket. Steering
    reverses only after `--steer-clear-sweeps` CONSECUTIVE alert-free
    monitor sweeps — hysteresis, so a flapping alert cannot turn
    dispatch into a lottery. Sustained burn additionally spawns standby
    replicas up to `--max-replicas` and retires them once the fleet is
    quiet again. Every action is a telemetry event (`router_steer`,
    `router_scale`, `class_brownout`) that `obs doctor` narrates.

  * **The router itself is no longer the SPOF** — a router WAL
    (`serve/router_journal.py`) journals every dispatch (original wire
    line, chosen replica, session key) and each stream's forwarded
    high-water mark, flushed ahead of the client write like the
    replica journals. Under `route --supervise` the router
    runs with its own heartbeat watchdog; a restarted router life
    RE-ADOPTS still-live replicas straight from their heartbeats
    (no respawn, no replay storm), recovers the WAL, and re-dispatches
    orphaned streams through the same dedup + seed-deterministic
    recompute path — the union stream across router lives stays
    bit-identical and duplicate-free. Clients ride it out with the
    wire protocol's `resume` verb (`serve/client.py` auto-reconnects
    and resumes from its own last received index).

Failure matrix (SERVING.md "Replica tier" has the long version):
replica crash → supervised restart + journal replay + router failover;
router crash → the supervisor restarts it, the new life re-adopts the
still-live replicas and recovers the dispatch WAL, and auto-resuming
clients reconnect and receive the rest of each stream exactly once;
both crash → replicas replay their journals first, the router
re-adopts (or respawns the dead), clients resume last.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path

from hyperion_tpu_torch.obs import slo as slo_mod
from hyperion_tpu_torch.obs.export import DEFAULT_WINDOW_S
from hyperion_tpu_torch.obs.heartbeat import host_rss_mb
from hyperion_tpu_torch.serve.client import TERMINAL_EVENTS, ServeClient
from hyperion_tpu_torch.serve.hostcache import prefix_root_digest
from hyperion_tpu_torch.serve.metrics import RouterMetrics
from hyperion_tpu_torch.serve.queue import (
    CLASS_BATCH,
    REJECT_BAD_REQUEST,
    REJECT_DRAINING,
    REJECT_NO_REPLICA,
    REJECT_QUEUE_FULL,
    BrownoutGovernor,
)
from hyperion_tpu_torch.serve.replica import SERVE_PHASES, READY, ReplicaHandle
from hyperion_tpu_torch.serve.router_journal import OrphanedDispatch, RouterJournal
from hyperion_tpu_torch.serve.server import _LineWriter, maybe_resume_doc
from hyperion_tpu_torch.utils.clock import SYSTEM
from hyperion_tpu_torch.utils.retry import RetryPolicy

# connect policy for replica dispatch: generous enough to ride a
# supervised restart (compile-cache warmups on real chips take seconds),
# bounded so a replica that never comes back fails over instead of
# hanging the relay
DISPATCH_CONNECT_RETRY = RetryPolicy(tries=8, base_delay_s=0.05,
                                     max_delay_s=1.0, deadline_s=20.0)


class ClientGone(Exception):
    """The CLIENT side of a relay died (its writer raised): the
    replica is healthy — this must never be mistaken for a replica
    failure, or one disconnecting client would eject the fleet."""


class _ClientWriter:
    """Wraps the client-facing writer so its failures raise ClientGone
    instead of the OSError the failover path treats as replica death."""

    def __init__(self, writer):
        self._w = writer

    def write(self, rec) -> None:
        try:
            self._w.write(rec)
        except Exception as e:  # noqa: BLE001 — any client-side failure
            raise ClientGone(repr(e)) from e


class StreamDedup:
    """Exactly-once filter over (possibly re-dispatched) token streams.

    Token records carry their stream index `i` (serve/server.py stamps
    it from the request's own token list). A failover re-dispatch
    recomputes the stream from index 0 — deterministic seeds make it
    bit-identical — and this filter drops everything the client already
    received. Records without an index (an old replica build) fall back
    to positional counting, which is still exact within one stream."""

    def __init__(self):
        self.delivered = 0

    def admit(self, rec: dict) -> bool:
        if rec.get("event") != "token":
            return True
        i = rec.get("i")
        if not isinstance(i, int):
            i = self.delivered
        if i < self.delivered:
            return False
        self.delivered = i + 1
        return True


class RouterPolicy:
    """Dispatch policy over a fleet of ReplicaHandles — pure host
    logic (no sockets, no processes) so `tests/test_router.py` drives
    it with fabricated heartbeats and zero jit compiles."""

    def __init__(self, replicas: list[ReplicaHandle], *,
                 affinity_slack: int = 4, affinity_cap: int = 512,
                 prefix_tokens: int = 32, prefix_chars: int = 128,
                 cache_aware: bool = True, clock=None):
        self.replicas = list(replicas)
        # wall-time source for eject/readmit decisions (heartbeats
        # stamp t_wall); injectable so the fleet simulator can run the
        # policy on virtual time
        self._clock = clock if clock is not None else SYSTEM
        self.affinity_slack = affinity_slack
        self.affinity_cap = affinity_cap
        self.prefix_tokens = prefix_tokens
        self.prefix_chars = prefix_chars
        self.cache_aware = cache_aware
        self._affinity: OrderedDict[str, int] = OrderedDict()
        self._ever_ready: set[int] = set()
        self._lock = threading.Lock()

    # -------------------------------------------------------- affinity

    def affinity_key(self, doc: dict) -> str | None:
        """Stickiness key: an explicit session beats a prompt prefix; a
        short prompt has no key (nothing worth pinning a replica for)."""
        sid = doc.get("session_id")
        if sid:
            return f"s:{sid}"
        ids = doc.get("prompt_ids")
        if isinstance(ids, list) and len(ids) >= self.prefix_tokens:
            head = ",".join(str(int(t)) for t in ids[:self.prefix_tokens])
            return "p:" + hashlib.sha1(head.encode()).hexdigest()[:16]
        prompt = doc.get("prompt")
        if isinstance(prompt, str) and len(prompt) >= self.prefix_chars:
            return "t:" + hashlib.sha1(
                prompt[:self.prefix_chars].encode()).hexdigest()[:16]
        return None

    # -------------------------------------------------------- dispatch

    def choose(self, doc: dict, exclude: set[int] | frozenset = frozenset(),
               ) -> tuple[ReplicaHandle | None, dict]:
        """Pick the dispatch target: the affinity-mapped replica when
        it is ready and within `affinity_slack` of the least-loaded
        score, else the least-loaded ready replica (ties broken by
        index, deterministically). Returns (replica, meta) with the
        replica's accounting already bumped — callers MUST `release`
        when the stream ends. (None, meta) when no ready replica
        remains outside `exclude`.

        Steering: a replica the router marked `steered` (burning its
        TTFT budget) is excluded for interactive requests while any
        un-steered alternative exists — batch traffic still flows to
        it, and with NO alternative interactive flows too (degraded
        service beats no service). Affinity yields the same way: a
        sticky key whose target is steered re-maps to a clean replica
        for the latency tier.

        Cache-aware term: when no affinity mapping fires, a replica
        that ADVERTISED this request's prefix-root digest on its last
        heartbeat (`prefix_roots`, from the engine's tiered KV cache)
        wins the dispatch if it sits within `affinity_slack` of the
        least-loaded score — its radix/host tiers already hold the
        prefix, so landing there skips the prefill the least-loaded
        replica would recompute. Past the slack (or with no advertiser)
        the policy degrades to plain least-loaded, and a successful
        steer seeds the affinity map so the rest of the burst sticks
        without re-consulting stale advertisements."""
        with self._lock:
            key = self.affinity_key(doc)
            meta = {"had_key": key is not None, "affinity_hit": False,
                    "steered_away": False, "cache_hit": False}
            ready = [r for r in self.replicas
                     if r.state == READY and r.index not in exclude]
            if not ready:
                return None, meta
            if str(doc.get("class", "")) != CLASS_BATCH:
                clear = [r for r in ready if not r.steered]
                if clear:
                    meta["steered_away"] = len(clear) < len(ready)
                    ready = clear
            best = min(ready, key=lambda r: (r.load_score(), r.index))
            target = best
            if key is not None:
                idx = self._affinity.get(key)
                cand = next((r for r in ready if r.index == idx), None)
                if cand is not None and cand.load_score() \
                        <= best.load_score() + self.affinity_slack:
                    target = cand
                    meta["affinity_hit"] = True
            if not meta["affinity_hit"] and self.cache_aware:
                ids = doc.get("prompt_ids")
                digest = (prefix_root_digest(ids)
                          if isinstance(ids, list) else None)
                if digest is not None:
                    hot = min((r for r in ready
                               if digest in r.hb_prefix_roots),
                              key=lambda r: (r.load_score(), r.index),
                              default=None)
                    if hot is not None and hot.load_score() \
                            <= best.load_score() + self.affinity_slack:
                        target = hot
                        meta["cache_hit"] = True
            if key is not None:
                self._affinity[key] = target.index
                self._affinity.move_to_end(key)
                while len(self._affinity) > self.affinity_cap:
                    self._affinity.popitem(last=False)
            target.inflight += 1
            target.dispatched_since_beat += 1
            target.dispatched_total += 1
            return target, meta

    def release(self, rep: ReplicaHandle) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)

    def add_replica(self, rep: ReplicaHandle) -> None:
        """Admit a scale-up standby into the dispatch set (it starts in
        STARTING and becomes dispatchable on its first serve beat, the
        same road every base replica walks)."""
        with self._lock:
            self.replicas.append(rep)

    def set_steered(self, rep: ReplicaHandle, on: bool) -> None:
        """Flip steering under the dispatch lock so choose() never sees
        a half-applied sweep."""
        with self._lock:
            rep.steered = on
            rep.steer_clear_sweeps = 0

    # ---------------------------------------------------------- health

    def eject(self, rep: ReplicaHandle, reason: str,
              now: float | None = None) -> bool:
        """Mark a replica not-dispatchable; True on a transition."""
        now = self._clock.wall() if now is None else now
        with self._lock:
            was = rep.state == READY
            rep.eject(now, reason)
            return was

    def observe_beats(self, read_hb, now: float | None = None,
                      stale_s: float = 10.0) -> list[tuple]:
        """One health sweep: feed each replica its latest heartbeat and
        apply the staleness rule. Returns transition tuples —
        ("ready"|"readmitted", replica) and ("ejected", replica,
        reason) — for the runtime to turn into events/metrics.
        `read_hb(path) -> dict | None` is injectable for tests."""
        now = self._clock.wall() if now is None else now
        # file I/O OUTSIDE the lock: a slow heartbeat read (NFS base
        # dir, big fleet) must never stall every relay's choose()
        beats = [read_hb(rep.heartbeat_path) for rep in self.replicas]
        out: list[tuple] = []
        with self._lock:
            for rep, hb in zip(self.replicas, beats):
                tr = rep.observe_beat(hb, now)
                if tr == "ready":
                    kind = ("readmitted" if rep.index in self._ever_ready
                            else "ready")
                    self._ever_ready.add(rep.index)
                    out.append((kind, rep))
                elif tr == "ejected":
                    # still beating, but draining/done: the handle
                    # already flipped state; surface the transition
                    out.append(("ejected", rep, rep.eject_reason))
                reason = rep.check_stale(now, stale_s)
                if reason is not None:
                    out.append(("ejected", rep, reason))
        return out

    @property
    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == READY)

    @property
    def inflight_total(self) -> int:
        with self._lock:
            return sum(r.inflight for r in self.replicas)


# ------------------------------------------------------------- runtime


def replica_argv(args, rep: ReplicaHandle) -> list[str]:
    """Child command for one replica: the serve surface the router
    fronts, with the per-replica socket/journal wired in. Chaos plans
    (`--replica-chaos IDX:PLAN`) attach only to their replica — the
    deterministic kill-one-mid-stream drill."""
    argv = [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "serve",
            "--ckpt", args.ckpt,
            "--device", args.device,
            "--dtype", args.dtype,
            "--socket", rep.socket_path,
            "--journal", rep.journal_path,
            "--max-len", str(args.max_len),
            "--slots", str(args.slots),
            "--block-size", str(args.block_size),
            "--num-blocks", str(args.num_blocks),
            "--queue-capacity", str(args.queue_capacity),
            "--prefill-budget", str(args.prefill_budget),
            "--prefill-chunk", str(getattr(args, "prefill_chunk", 0)),
            "--interactive-weight",
            str(getattr(args, "interactive_weight", 3)),
            "--batch-weight", str(getattr(args, "batch_weight", 1)),
            "--batch-capacity", str(getattr(args, "batch_capacity", 0)),
            "--batch-deadline-s",
            str(getattr(args, "batch_deadline_s", 0.0)),
            "--max-new-default", str(args.max_new_default),
            "--warmup-lens", args.warmup_lens,
            "--heartbeat-every", str(args.replica_heartbeat_every),
            "--drain-timeout", str(args.drain_timeout)]
    argv.append("--prefix-cache" if args.prefix_cache
                else "--no-prefix-cache")
    # tiered KV host spill (serve/hostcache.py) rides to every replica;
    # the hot prefix roots their heartbeats advertise back feed the
    # dispatch policy's cache-aware steering
    hc = int(getattr(args, "host_cache_mb", 0) or 0)
    if hc:
        argv += ["--host-cache-mb", str(hc)]
    # engine-level SLO targets ride to every replica (the TTFT
    # histograms live in the engines; the router only tallies the
    # alerts their heartbeats report back)
    for flag, val in (("--slo-ttft-p99-ms", args.slo_ttft_p99_ms),
                      ("--slo-reject-rate", args.slo_reject_rate),
                      ("--slo-availability", args.slo_availability),
                      ("--slo-fast-s", args.slo_fast_s),
                      ("--slo-slow-s", args.slo_slow_s)):
        if val:
            argv += [flag, str(val)]
    if args.no_tokenizer:
        argv.append("--no-tokenizer")
    else:
        argv += ["--tokenizer-dir", args.tokenizer_dir]
    if args.eos_id is not None:
        argv += ["--eos-id", str(args.eos_id)]
    plan = dict(p.split(":", 1) for p in (args.replica_chaos or [])
                if ":" in p).get(str(rep.index))
    if plan:
        argv += ["--chaos", plan]
    return argv


def _route_window_value(reg, metric: str, window_s: float,
                        now: float | None = None,
                        min_count: int = 1) -> float | None:
    """Router-level SLO metric: the fraction of finished relays the
    ROUTER rejected (fleet saturation / no-replica), windowed. Engine
    rejects a replica absorbed via re-dispatch never count — those are
    the router doing its job."""
    if metric == "reject_rate":
        return slo_mod.counter_ratio(reg, ("route_rejected",),
                                     ("route_completed",), window_s, now)
    return None


class FleetActions:
    """The acting half of the monitor sweep — alert tallying,
    steer/unsteer hysteresis, and the burning-count scale governor over
    a `RouterPolicy` — factored free of threads, sockets, and
    subprocesses. The live `Router` drives it from its monitor thread
    with real side-effect callbacks (control-socket brownout orders,
    child spawn/retire); the fleet simulator (`serve/simulate.py`)
    drives the SAME object on a virtual clock with synthetic callbacks,
    so steer/scale policy has exactly one implementation wherever it
    runs."""

    def __init__(self, policy: RouterPolicy, metrics: RouterMetrics,
                 tracer, *, act: bool = True,
                 steer_clear_sweeps: int = 3,
                 scale_gov: BrownoutGovernor | None = None,
                 order_brownout=None, scale_up=None, scale_down=None,
                 scaling_paused=None, log=None):
        self.policy = policy
        self.metrics = metrics
        self.tracer = tracer
        self.act = bool(act)
        self.steer_clear_sweeps = max(1, int(steer_clear_sweeps or 3))
        self.scale_gov = scale_gov
        self._order_brownout = order_brownout or (lambda rep, on: None)
        self._scale_up = scale_up or (lambda: None)
        self._scale_down = scale_down or (lambda: None)
        self._scaling_paused = scaling_paused or (lambda: False)
        self._log = log or (lambda msg: None)
        # alert names already seen per replica, so the fleet tally
        # counts RAISES, not beats
        self._alert_seen: dict[int, set] = {}

    def sweep_alerts(self) -> list[str]:
        """Fleet alert surfacing: each replica's heartbeat carries the
        SLO alerts its engine has FIRING (obs/slo.py); tally them so
        one `obs top` row — and one router_end field — answers "is
        anything alarming, anywhere" without opening N streams. New
        names count as raises; a name persisting across beats does not
        re-count. Only a DISPATCHABLE replica's alerts count: an
        ejected/dead child's last beat would otherwise keep a ghost
        alert firing fleet-wide forever (the dead replica itself is
        already a named incident — its stale alarm must not page on
        top of it). A restarted replica still alerting re-counts on
        readmission: a new observation epoch, honestly re-raised."""
        fleet_alerts: list[str] = []
        new_raises = 0
        for rep in self.policy.replicas:
            cur = set(rep.hb_alerts) if rep.state == READY else set()
            fleet_alerts += [f"r{rep.index}:{a}" for a in sorted(cur)]
            fresh = cur - self._alert_seen.get(rep.index, set())
            for a in sorted(fresh):
                new_raises += 1
                self.tracer.event("replica_alert", replica=rep.index,
                                  alert=a)
            self._alert_seen[rep.index] = cur
        self.metrics.on_fleet_alerts(new_raises)
        return fleet_alerts

    @staticmethod
    def burning(rep: ReplicaHandle) -> bool:
        """A READY replica reporting any TTFT-family SLO alert on its
        last beat — the one signal that says the LATENCY tier is being
        hurt there right now (reject/availability alerts have their own
        remedies: failover and restart already handle those)."""
        return rep.state == READY and any("ttft" in a for a in rep.hb_alerts)

    def sweep(self) -> int:
        """Steer/unsteer each replica off its heartbeat alerts, then
        feed the burning count to the scale governor. Returns the
        burning count (rides the router heartbeat). No-op when not
        acting — the fleet is then observed and tallied only."""
        if not self.act:
            return 0
        burning = 0
        for rep in self.policy.replicas:
            if self.burning(rep):
                burning += 1
                if not rep.steered:
                    self.policy.set_steered(rep, True)
                    self.metrics.on_steer(True)
                    self.tracer.event("router_steer", replica=rep.index,
                                      on=True,
                                      alerts=list(rep.hb_alerts))
                    self._log(f"[route] replica {rep.index} steered: "
                              f"{','.join(rep.hb_alerts)}")
                    self._order_brownout(rep, True)
                else:
                    rep.steer_clear_sweeps = 0
            elif rep.steered and rep.state == READY:
                # hysteresis: only CONSECUTIVE alert-free sweeps of a
                # beating replica count toward unsteer — an ejected
                # replica's silence is not evidence of recovery
                rep.steer_clear_sweeps += 1
                if rep.steer_clear_sweeps >= self.steer_clear_sweeps:
                    self.policy.set_steered(rep, False)
                    self.metrics.on_steer(False)
                    self.tracer.event("router_steer", replica=rep.index,
                                      on=False)
                    self._log(f"[route] replica {rep.index} unsteered "
                              f"after {self.steer_clear_sweeps} clean "
                              f"sweeps")
                    self._order_brownout(rep, False)
        self.metrics.observe_steered(
            sum(1 for r in self.policy.replicas if r.steered))
        if self.scale_gov is not None and not self._scaling_paused():
            tr = self.scale_gov.update(burning)
            if tr == "enter":
                self._scale_up()
            elif tr == "exit":
                self._scale_down()
        return burning


class Router:
    """The running fleet: supervisor thread per replica, a heartbeat
    monitor, and one relay thread per in-flight request."""

    def __init__(self, args, tracer, hb,
                 metrics: RouterMetrics | None = None,
                 child_argv_fn=replica_argv, clock=None):
        self.args = args
        self._clock = clock if clock is not None else SYSTEM
        self.tracer = tracer
        self.hb = hb
        self.metrics = metrics or RouterMetrics()
        # which supervised life of this router is running (the
        # supervisor stamps HYPERION_ATTEMPT per restart): rides every
        # hop context so a fleet trace can tell "dispatched before the
        # router crash" from "re-dispatched by the next life"
        self.router_life = int(
            os.environ.get("HYPERION_ATTEMPT", "0") or 0)
        # injectable child command (tests run the router runtime over
        # fake replicas that speak the wire protocol)
        self._child_argv_fn = child_argv_fn
        base = Path(args.base_dir)
        self.replicas = [ReplicaHandle.under(base, i)
                         for i in range(args.replicas)]
        self.policy = RouterPolicy(
            self.replicas,
            affinity_slack=args.affinity_slack,
            prefix_tokens=args.affinity_prefix,
            clock=self._clock)
        self._procs: dict[int, subprocess.Popen] = {}
        self._sup_threads: list[threading.Thread] = []
        self._req_threads: list[threading.Thread] = []
        self._active: set[str] = set()
        self._req_lock = threading.Lock()
        self._rids = itertools.count()
        self._stopping = threading.Event()   # no new work
        self._hard_stop = threading.Event()  # abandon in-flight relays
        # router-scoped chaos (crash@dispatch, conn_reset): its state
        # file sits next to the WAL so dispatch-count faults fire once
        # per supervisor LINEAGE, not once per router life
        self.chaos = None
        if getattr(args, "chaos", ""):
            from hyperion_tpu_torch.testing import chaos as chaos_mod

            self.chaos = chaos_mod.activate(
                args.chaos, state_path=base / "route_chaos_state.json")
        # the router WAL (serve/router_journal.py): dispatch records +
        # forwarded high-water marks, recovered by the next router life
        jpath = str(getattr(args, "router_journal", "") or "")
        self.journal: RouterJournal | None = None
        if jpath not in ("off", "none", "0"):
            self.journal = RouterJournal(
                jpath or str(base / "router_journal.jsonl"),
                fault=(self.chaos.journal_io
                       if self.chaos is not None else None))
        self._dispatch_n = itertools.count(1)  # chaos crash@dispatch
        # resume bookkeeping: original wire lines by request id (bounded
        # — a resume for an evicted id falls back to the WAL or the
        # client's carried request), plus WAL orphans awaiting a
        # socket-mode client's resume verb
        self._resume_docs: OrderedDict[str, str] = OrderedDict()
        self._recovered: dict[str, OrphanedDispatch] = {}
        self._mon_stop = threading.Event()
        self._mon_thread: threading.Thread | None = None
        # acting state: steer hysteresis + the scale governor.
        # The governor is the queue's own BrownoutGovernor watching the
        # count of BURNING replicas as its "depth" — enter (>=1 burning)
        # spawns a standby, exit (0 burning) retires one, and the
        # hysteresis that keeps brownout from flapping keeps the fleet
        # size from flapping too.
        self._act = bool(getattr(args, "act", True))
        self._steer_clear_sweeps = max(
            1, int(getattr(args, "steer_clear_sweeps", 3)))
        self._max_replicas = int(getattr(args, "max_replicas", 0) or 0)
        self._scale_gov = None
        if self._act and self._max_replicas > len(self.replicas):
            self._scale_gov = BrownoutGovernor(depth_high=1)
        # the shared steer/scale sweep (FleetActions): the Router wires
        # in its real side effects — control-socket brownout orders and
        # child spawn/retire — where the simulator wires synthetic ones
        self.actions = FleetActions(
            self.policy, self.metrics, tracer,
            act=self._act,
            steer_clear_sweeps=self._steer_clear_sweeps,
            scale_gov=self._scale_gov,
            order_brownout=self._order_class_brownout,
            scale_up=self._scale_up, scale_down=self._scale_down,
            scaling_paused=self._stopping.is_set, log=self._log)
        self._exporter = None
        self._slo = None
        route_budget = getattr(args, "slo_reject_rate", 0.0) or 0.0
        if route_budget > 0:
            self._slo = slo_mod.SLOMonitor(
                (slo_mod.SLOTarget("route_reject_rate", "reject_rate",
                                   float(route_budget)),),
                self.metrics.reg,
                fast_s=getattr(args, "slo_fast_s", 0.0)
                or slo_mod.DEFAULT_FAST_S,
                slow_s=getattr(args, "slo_slow_s", 0.0)
                or slo_mod.DEFAULT_SLOW_S,
                value_fn=_route_window_value)

    # ----------------------------------------------------------- fleet

    def _log(self, msg: str) -> None:
        # stderr always: stdout is the client's JSONL wire stream
        print(msg, file=sys.stderr, flush=True)

    def _notify_eject(self, rep: ReplicaHandle, reason: str) -> None:
        """THE ejection emission — metric (unless this is the planned
        shutdown taking everyone out), event, stderr line. Callers must
        only invoke it for a transition that actually happened."""
        if not self._stopping.is_set():
            self.metrics.on_eject()
        self.tracer.event("replica_ejected", replica=rep.index,
                          reason=reason)
        self._log(f"[route] replica {rep.index} ejected: {reason}")

    def _eject(self, rep: ReplicaHandle, reason: str) -> None:
        if self.policy.eject(rep, reason):
            self._notify_eject(rep, reason)

    def _adopt_live(self, rep: ReplicaHandle) -> int | None:
        """A previous router life's child may still be alive and
        serving — restarting it would throw away its warm caches and
        force a pointless journal replay. Adoption test: a fresh
        serve-phase heartbeat whose pid answers signal 0. Returns the
        live pid, or None (spawn normally)."""
        from hyperion_tpu_torch.obs.heartbeat import read_heartbeat

        hb = read_heartbeat(rep.heartbeat_path)
        if not isinstance(hb, dict):
            return None
        t_wall = hb.get("t_wall")
        pid = hb.get("pid")
        if hb.get("phase") not in SERVE_PHASES \
                or not isinstance(t_wall, (int, float)) \
                or self._clock.wall() - float(t_wall) > self.args.stale_s \
                or not isinstance(pid, int) or pid <= 0:
            return None
        try:
            os.kill(pid, 0)
        except (OSError, ProcessLookupError):
            return None
        return pid

    def _babysit_adopted(self, rep: ReplicaHandle, pid: int) -> bool:
        """Watch an adopted child until it dies or we stop. True means
        the router is stopping/retiring it (supervisor thread should
        end); False means the child died — fall through to a normal
        supervised respawn."""
        hang = self.args.hang_timeout
        while True:
            if self._stopping.is_set() or rep.retiring:
                return True
            try:
                os.kill(pid, 0)
            except (OSError, ProcessLookupError):
                return False
            if hang > 0 and rep.hb_t_wall is not None \
                    and self._clock.wall() - rep.hb_t_wall > hang:
                # wedged exactly like a spawned child would be: the
                # watchdog contract applies to adoptees too
                self._log(f"[route] adopted replica {rep.index} "
                          f"heartbeat stale past {hang:.0f}s — SIGKILL "
                          f"pid {pid}")
                try:
                    os.kill(pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
                return False
            time.sleep(0.25)

    def _supervise_one(self, rep: ReplicaHandle) -> None:
        from hyperion_tpu_torch.supervisor import (
            Decision,
            heartbeat_watchdog,
            supervise_loop,
        )

        pid = self._adopt_live(rep)
        if pid is not None:
            rep.adopted = True
            self.metrics.on_adopt()
            self.tracer.event("replica_adopted", replica=rep.index,
                              pid=pid)
            self._log(f"[route] replica {rep.index} adopted from a "
                      f"previous router life (pid {pid}) — serving "
                      "continues uninterrupted")
            if self._babysit_adopted(rep, pid):
                return
            rep.adopted = False
            self._eject(rep, "adopted replica died")
            self.tracer.event("replica_exit", replica=rep.index,
                              rc=None, adopted=True)
            if self._stopping.is_set() or rep.retiring:
                return
            rep.restarts += 1  # the respawn below is a restart

        try:
            err_fd = sys.stderr.fileno()
        except Exception:  # noqa: BLE001
            err_fd = 2  # pytest capture replaces sys.stderr objects
        runner = heartbeat_watchdog(
            rep.heartbeat_path, self.args.hang_timeout, log=self._log,
            on_spawn=lambda p: self._procs.__setitem__(rep.index, p),
            # the children's stdout must never reach the router's —
            # chaos chatter and stray prints go where supervisor logs go
            popen_kwargs={"stdout": err_fd},
        )

        def run(argv: list, env: dict) -> int:
            env = {**env,
                   # the heartbeat IS the router's control plane: force
                   # each child's stream on, to its own dir, whatever
                   # the operator chose for the router's telemetry
                   "HYPERION_TELEMETRY": rep.telemetry_path,
                   "HYPERION_REPLICA": str(rep.index)}
            env.pop("HYPERION_HEARTBEAT", None)
            return runner(argv, env)

        def decide(rc: int) -> Decision:
            self._eject(rep, f"child exit {rc}")
            self.tracer.event("replica_exit", replica=rep.index, rc=rc)
            if self._stopping.is_set() or rep.retiring:
                return Decision.stop(0)
            rep.restarts += 1
            # restart immediately: an ejected replica costs fleet
            # capacity every second, and the journal replay it owes is
            # idempotent — backoff belongs to crash LOOPS, which the
            # per-replica restart budget already bounds
            return Decision.restart(immediate=rep.restarts <= 1)

        rc = supervise_loop(
            self._child_argv_fn(self.args, rep), decide=decide,
            max_restarts=self.args.max_restarts, run_child=run,
            label=f"replica{rep.index}", log=self._log)
        # always logged (the eject below is silent when the relay's
        # connection error ejected first): a supervisor that stops
        # while the router is still serving is a fact the operator —
        # and any flake hunt — needs on stderr
        self._log(f"[route] replica {rep.index} supervisor done "
                  f"(rc {rc}, restarts {rep.restarts}, "
                  f"stopping={self._stopping.is_set()})")
        self._eject(rep, f"supervisor finished (rc {rc})")

    def exposition(self, window_s: float = DEFAULT_WINDOW_S) -> dict:
        """Live snapshot for the router's exposition socket: fleet
        table (per-replica state/occupancy/alerts from the handles the
        monitor keeps fresh) + the router's own metrics. Host-only —
        the router never touches the card, and neither does this."""
        reps = [{
            "replica": r.index, "state": r.state, "phase": r.hb_phase,
            "active": r.hb_active, "queue": r.hb_queue,
            "inflight": r.inflight, "restarts": r.restarts,
            "alerts": list(r.hb_alerts),
            "steered": r.steered, "standby": r.standby,
        } for r in self.replicas]
        msum = self.metrics.summary()
        own = (self._slo.active_names() if self._slo is not None else [])
        # the aggregated list counts READY replicas only (a dead
        # child's stale alarm is not a live alert); the per-replica
        # rows keep the last-known alerts next to their state, so the
        # evidence is still on the board
        fleet = [f"r{r['replica']}:{a}" for r in reps
                 if r["state"] == READY for a in r["alerts"]]
        return {
            "role": "router",
            "run": self.tracer.run,
            "phase": "route",
            "step": msum["dispatched"],
            "active": self.policy.inflight_total,
            "queue": 0,
            "ready": self.policy.ready_count,
            "draining": self._stopping.is_set(),
            "alerts": own + fleet,
            "replicas": reps,
            # what the acting layer is doing RIGHT NOW — `obs top`'s
            # act column and the doctor's router-action narration
            "act": {
                "enabled": self._act,
                "steered": [r.index for r in self.replicas if r.steered],
                "fleet": len(self.replicas),
                "max_replicas": self._max_replicas,
                # crash-safety counters: replicas adopted from a dead
                # router life, client streams resumed across the cut
                "adopted": msum["adopted"],
                "resumes": msum["resumes"],
            },
            "metrics": self.metrics.reg.snapshot(),
            "windows": self.metrics.reg.windowed_snapshot(window_s),
            # host memory only: the router holds no params and no KV
            # pool, but its RSS still belongs on the obs top board
            "memory": {"rss_mb": host_rss_mb()},
        }

    def _sweep_fleet_alerts(self) -> list[str]:
        """Delegates to the shared `FleetActions` sweep (the simulator
        drives the same object)."""
        return self.actions.sweep_alerts()

    # --------------------------------------------- acting on alerts

    _burning = staticmethod(FleetActions.burning)

    def _order_class_brownout(self, rep: ReplicaHandle,
                              active: bool) -> None:
        """One control verb to one replica's engine over its exposition
        socket: clamp/shed the batch tier (or lift the order). Best-
        effort — a replica that predates the verb, or is mid-restart,
        simply doesn't ack; steering alone still protects the latency
        tier, and the event records `acked` either way so the doctor
        can tell an ignored order from an obeyed one."""
        from hyperion_tpu_torch.obs.export import (
            exposition_path,
            request_control,
        )

        resp = None
        try:
            resp = request_control(
                exposition_path(rep.heartbeat_path),
                {"cmd": "class_brownout", "active": active},
                timeout_s=2.0)
        except Exception:  # noqa: BLE001 — an order must never kill
            pass           # the monitor thread
        acked = isinstance(resp, dict) and resp.get("status") == "ok"
        self.metrics.on_class_brownout(active)
        self.tracer.event("class_brownout", replica=rep.index,
                          active=active, acked=acked)
        self._log(f"[route] replica {rep.index} class_brownout "
                  f"{'on' if active else 'off'}"
                  f"{'' if acked else ' (no ack)'}")

    def _sweep_actions(self) -> int:
        """The acting half of the monitor sweep (`--no-act` turns it
        off — the router then observes and tallies only). Delegates to the shared `FleetActions` object."""
        self.actions.act = self._act
        return self.actions.sweep()

    def _scale_up(self) -> None:
        """Spawn one standby replica (the next index under the base
        dir) — same supervisor road as the base fleet, dispatchable on
        its first serve beat."""
        idx = len(self.replicas)
        if idx >= self._max_replicas:
            return
        rep = ReplicaHandle.under(Path(self.args.base_dir), idx)
        rep.standby = True
        rep.dir.mkdir(parents=True, exist_ok=True)
        self.replicas.append(rep)
        self.policy.add_replica(rep)
        t = threading.Thread(target=self._supervise_one, args=(rep,),
                             name=f"replica{rep.index}-sup", daemon=True)
        t.start()
        self._sup_threads.append(t)
        self.metrics.on_scale(True)
        self.tracer.event("router_scale", direction="up",
                          replica=rep.index, fleet=len(self.replicas))
        self._log(f"[route] scale up: standby replica {rep.index} "
                  f"spawning ({len(self.replicas)}/{self._max_replicas})")

    def _scale_down(self) -> None:
        """Retire the youngest live standby: eject it from dispatch
        (in-flight relays fail over exactly like a crash — exactly-once
        delivery holds), terminate the child, and let its supervisor's
        decide() see `retiring` and stop instead of restarting."""
        rep = next((r for r in reversed(self.replicas)
                    if r.standby and not r.retiring), None)
        if rep is None:
            return
        rep.retiring = True
        self._eject(rep, "retired (scale-down)")
        proc = self._procs.get(rep.index)
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
            except OSError:
                pass
        self.metrics.on_scale(False)
        self.tracer.event("router_scale", direction="down",
                          replica=rep.index,
                          fleet=sum(1 for r in self.replicas
                                    if not r.retiring))
        self._log(f"[route] scale down: standby replica {rep.index} "
                  f"retiring")

    def start(self) -> None:
        self.tracer.event(
            "router_start", replicas=len(self.replicas),
            slots=self.args.slots, max_len=self.args.max_len,
            stale_s=self.args.stale_s,
            affinity_prefix=self.args.affinity_prefix)
        self.hb.pulse(phase="route_spawn", ready=0)
        if self.hb.enabled:
            # obs.sock next to the router's heartbeat — `obs top` on
            # the base dir reads the whole fleet through this one
            # socket even before it walks the replica dirs
            from hyperion_tpu_torch.obs.export import (
                MetricsExporter,
                exposition_path,
            )

            self._exporter = MetricsExporter(
                exposition_path(self.hb.path), self.exposition,
                label="route-obs").start()
        for rep in self.replicas:
            rep.dir.mkdir(parents=True, exist_ok=True)
            t = threading.Thread(target=self._supervise_one, args=(rep,),
                                 name=f"replica{rep.index}-sup",
                                 daemon=True)
            t.start()
            self._sup_threads.append(t)
        self._mon_thread = threading.Thread(
            target=self._monitor, name="route-monitor", daemon=True)
        self._mon_thread.start()

    def _monitor(self, poll_s: float = 0.25) -> None:
        from hyperion_tpu_torch.obs.heartbeat import read_heartbeat

        last_snap = 0.0
        while not self._mon_stop.is_set():
            for tr in self.policy.observe_beats(
                    read_heartbeat, stale_s=self.args.stale_s):
                if tr[0] in ("ready", "readmitted"):
                    rep = tr[1]
                    if tr[0] == "readmitted":
                        self.metrics.on_readmit()
                    self.tracer.event(f"replica_{tr[0]}",
                                      replica=rep.index,
                                      restarts=rep.restarts)
                    self._log(f"[route] replica {rep.index} {tr[0]} "
                              f"(pid {rep.hb_pid})")
                else:
                    # observe_beats already flipped the handle's state
                    # (the tuple IS the transition) — notify directly,
                    # the idempotent _eject would swallow it
                    self._notify_eject(tr[1], tr[2])
            ready = self.policy.ready_count
            inflight = self.policy.inflight_total
            fleet_alerts = self._sweep_fleet_alerts()
            self._sweep_actions()
            self.metrics.observe_fleet(ready, inflight,
                                       alerts_active=len(fleet_alerts))
            if self._slo is not None:
                trs = self._slo.evaluate()
                if trs:
                    slo_mod.publish(trs, self.tracer, self.metrics.reg,
                                    prefix="route",
                                    active=len(self._slo.active))
            self.hb.beat(step=self.metrics.summary()["dispatched"],
                         phase="route", active=inflight, queue=0,
                         ready=ready, alerts=fleet_alerts)
            now = self._clock()
            if now - last_snap >= 5.0:
                self.tracer.snapshot(self.metrics.reg)
                last_snap = now
            self._mon_stop.wait(poll_s)

    def wait_ready(self, n: int = 1, timeout_s: float = 120.0) -> bool:
        t0 = self._clock()
        while self._clock() - t0 < timeout_s:
            if self.policy.ready_count >= n:
                return True
            if self._hard_stop.is_set():
                return False
            time.sleep(0.1)
        return self.policy.ready_count >= n

    # --------------------------------------------------------- intake

    @property
    def requests_idle(self) -> bool:
        with self._req_lock:
            return not self._active

    def begin_drain(self) -> None:
        if not self._stopping.is_set():
            self._stopping.set()
            self.tracer.event("router_draining",
                              inflight=self.policy.inflight_total)

    def submit_line(self, line: str, writer) -> threading.Thread | None:
        """Parse the routing envelope of one wire line and hand it to a
        relay thread. Malformed lines reject immediately with the
        standard vocabulary — never an exception on the intake path.
        The wire protocol's `resume` verb takes the resume path
        instead of a fresh dispatch."""
        if (rdoc := maybe_resume_doc(line)) is not None:
            return self._resume(rdoc, writer)
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError("request line must be a JSON object")
        except (json.JSONDecodeError, ValueError) as e:
            self.metrics.on_reject(REJECT_BAD_REQUEST)
            self.tracer.event("request_rejected",
                              request=f"unparsed_{next(self._rids)}",
                              reason=REJECT_BAD_REQUEST,
                              error=str(e)[:200], queued_s=0.0)
            writer.write({"id": None, "event": "error",
                          "error": f"bad json: {e}"})
            return None
        if not doc.get("id"):
            doc["id"] = f"route_{next(self._rids)}"
        rid = str(doc["id"])
        if self._stopping.is_set():
            self._reject(rid, REJECT_DRAINING, self._clock(), writer)
            return None
        # the WAL line: the request exactly as the client sent it (plus
        # the minted id) — what a NEXT router life needs to re-dispatch.
        # Remembered in-process too, so a client resume after conn_reset
        # does not depend on the client carrying its request back.
        wal_line = json.dumps(doc, separators=(",", ":"))
        self._resume_docs[rid] = wal_line
        while len(self._resume_docs) > 1024:
            self._resume_docs.popitem(last=False)
        with self._req_lock:
            self._active.add(rid)
        t = threading.Thread(target=self._relay,
                             args=(rid, doc, writer),
                             kwargs={"wal_line": wal_line},
                             name=f"relay-{rid}", daemon=True)
        t.start()
        if len(self._req_threads) > 256:
            # a long-lived router must not accumulate dead thread
            # objects one per request served
            self._req_threads = [x for x in self._req_threads
                                 if x.is_alive()]
        self._req_threads.append(t)
        return t

    def _reject(self, rid: str, reason: str, submitted: float,
                writer) -> None:
        self.metrics.on_reject(reason)
        self.tracer.event(
            "request_rejected", request=rid, reason=reason,
            queued_s=round(max(0.0, self._clock() - submitted), 6))
        if self.journal is not None:
            self.journal.done(rid, reason)
        writer.write({"id": rid, "event": "rejected", "reason": reason})

    # ---------------------------------------------------------- relay

    def _relay(self, rid: str, doc: dict, writer, *,
               resume_from: int = 0, wal_line: str | None = None,
               as_resume: bool = False, hop_base: int = 0) -> None:
        try:
            self._relay_inner(rid, doc, _ClientWriter(writer),
                              resume_from=resume_from, wal_line=wal_line,
                              as_resume=as_resume, hop_base=hop_base)
        except ClientGone as e:
            # the CLIENT vanished mid-stream: its request dies with it
            # (nothing left to deliver to), the replica keeps serving —
            # the engine's own dropped-sink handling finishes the slot.
            # Terminal in the WAL too: a RESUME re-opens it (the parse
            # side treats dispatch-after-done as exactly that), but a
            # router death must not re-dispatch a stream whose client
            # already walked away.
            if self.journal is not None:
                self.journal.done(rid, "client_gone")
            self.tracer.event("client_disconnected", request=rid,
                              error=str(e)[:200])
        except Exception as e:  # noqa: BLE001 — a relay bug must reject
            # its request, never silently strand the client's stream
            try:
                self._reject(rid, REJECT_BAD_REQUEST, self._clock(),
                             writer)
            except Exception:  # noqa: BLE001 — reject write to a dead
                pass           # client must not mask the real error
            self._log(f"[route] relay {rid} failed: {e!r}")
        finally:
            with self._req_lock:
                self._active.discard(rid)

    def _relay_inner(self, rid: str, doc: dict, writer, *,
                     resume_from: int = 0, wal_line: str | None = None,
                     as_resume: bool = False, hop_base: int = 0) -> None:
        submitted = self._clock()
        dedup = StreamDedup()
        # a resume (client-driven or WAL orphan re-dispatch) floors the
        # dedup at what was already forwarded — the replica recomputes
        # the identical stream from 0 and only the remainder passes
        dedup.delivered = max(0, int(resume_from))
        crashed: set[int] = set()   # replicas this request already
        #                             visited: their journals hold its
        #                             admit record — never go back
        qfull: set[int] = set()
        deadline = submitted + self.args.dispatch_timeout
        redispatches = 0
        saw_qfull = False
        backoff = 0.05
        # failover-gap clock: starts the instant a replica death is
        # detected, stops at the FIRST record the client sees from the
        # replacement — connect retries against a restarting replica
        # ARE the gap, so the stop lives inside the next stream
        fail_at: float | None = None

        def _gap_done() -> None:
            nonlocal fail_at
            if fail_at is not None:
                self.metrics.on_failover_gap(self._clock() - fail_at)
                fail_at = None

        trace: dict = {"id": rid, "hop": hop_base, "attempt": 0,
                       "router_life": self.router_life}
        while True:
            if self._hard_stop.is_set():
                self._reject(rid, REJECT_DRAINING, submitted, writer)
                return
            rep, meta = self.policy.choose(doc, exclude=crashed | qfull)
            if rep is None:
                if self._clock() > deadline:
                    self._reject(
                        rid,
                        REJECT_QUEUE_FULL if saw_qfull
                        else REJECT_NO_REPLICA,
                        submitted, writer)
                    return
                # every ready replica rejected queue_full this sweep:
                # clear the sweep set and retry after a breath — the
                # fleet may drain, and the deadline bounds the wait
                qfull.clear()
                time.sleep(backoff)
                backoff = min(backoff * 2.0, 0.5)
                continue
            self.metrics.on_dispatch(rep.index, meta["affinity_hit"],
                                     meta["had_key"],
                                     cache_hit=meta.get("cache_hit",
                                                        False))
            # the hop context: trace id = the minted request id; `hop`
            # counts placements across the request's WHOLE journey
            # (resume relays continue past the legs a previous relay
            # already burned via hop_base), `attempt` counts
            # re-dispatch retries within THIS relay
            trace = {"id": rid, "hop": hop_base + redispatches,
                     "attempt": redispatches,
                     "router_life": self.router_life}
            self.tracer.event(
                "route_dispatch", request=rid, replica=rep.index,
                affinity=meta["affinity_hit"],
                cache_steer=meta.get("cache_hit", False),
                redispatch=redispatches, trace=trace)
            # WAL before wire: the placement is durable before the
            # replica can possibly have seen the request. The stored
            # line stays the request exactly as the client sent it —
            # the hop context rides a separate record field.
            if self.journal is not None:
                self.journal.dispatch(
                    rid,
                    line=(wal_line if wal_line is not None
                          else json.dumps(doc, separators=(",", ":"))),
                    replica=rep.index,
                    session=self.policy.affinity_key(doc),
                    n=redispatches, trace=trace)
            if self.chaos is not None:
                # counts every placement router-wide — the
                # crash@dispatch=N drill's trigger
                self.chaos.on_dispatch(next(self._dispatch_n))
            send_doc = dict(doc)
            send_doc["trace"] = trace
            try:
                outcome, terminal = self._stream_from(rep, rid, send_doc,
                                                      dedup, writer,
                                                      as_resume=as_resume,
                                                      gap_cb=_gap_done)
            except (OSError, ConnectionError, ValueError) as e:
                # mid-stream death (or connect that never came up):
                # eject, fail over. The renewed deadline is deliberate —
                # this request was admitted somewhere; dropping it now
                # would turn one replica crash into client-visible loss
                self._eject(rep, f"connection error "
                                 f"({e.__class__.__name__})")
                crashed.add(rep.index)
                redispatches += 1
                if fail_at is None:
                    fail_at = self._clock()
                self.metrics.on_redispatch("replica_lost")
                self.tracer.event("route_redispatch", request=rid,
                                  from_replica=rep.index,
                                  reason="replica_lost",
                                  delivered=dedup.delivered,
                                  trace=trace)
                deadline = max(deadline, self._clock()
                               + self.args.dispatch_timeout)
                continue
            finally:
                # whatever ends the attempt — terminal, failover, or a
                # relay bug propagating out — the load accounting must
                # not leak an inflight count
                self.policy.release(rep)
            if outcome == "queue_full":
                saw_qfull = True
                qfull.add(rep.index)
                redispatches += 1
                self.metrics.on_redispatch(REJECT_QUEUE_FULL)
                self.tracer.event("route_redispatch", request=rid,
                                  from_replica=rep.index,
                                  reason=REJECT_QUEUE_FULL,
                                  trace=trace)
                continue
            self.metrics.on_complete()
            if self.journal is not None:
                self.journal.done(rid, outcome)
            self.tracer.event(
                "route_complete", request=rid, replica=rep.index,
                status=outcome, tokens=dedup.delivered,
                redispatches=redispatches,
                e2e_s=round(self._clock() - submitted, 6),
                trace=trace)
            return

    def _stream_from(self, rep: ReplicaHandle, rid: str, doc: dict,
                     dedup: StreamDedup, writer,
                     as_resume: bool = False,
                     gap_cb=None) -> tuple[str, dict]:
        """One dispatch attempt: open the replica stream, forward
        deduplicated records to the client. Returns (outcome, terminal
        record) where outcome is the terminal event name or
        "queue_full" (the one rejection the router retries elsewhere
        instead of forwarding). Raises OSError/ConnectionError on a
        dead replica — the caller's failover path.

        `as_resume` relays the request as the wire protocol's resume
        verb instead of the raw request: the replica suffixes its
        internal wire id, so a replica that already holds this id's
        admit record (it served the stream before the crash) never
        sees a duplicate id on its journal."""
        with ServeClient(rep.socket_path,
                         timeout_s=self.args.stream_timeout,
                         retry=DISPATCH_CONNECT_RETRY) as client:
            if as_resume:
                stream = client.stream(
                    kind="resume", request_id=rid,
                    next_index=dedup.delivered, request=doc, id=rid)
            else:
                stream = client.stream(**doc)
            for rec in stream:
                if gap_cb is not None:
                    # first record from this replica closes any open
                    # failover gap (no-op when none is running)
                    gap_cb()
                ev = rec.get("event")
                if ev == "token":
                    if dedup.admit(rec):
                        # hwm ahead of the client write (mirror of the
                        # replica journal's journal-before-sink rule):
                        # a router death between the two costs AT MOST
                        # one replayed-and-deduped token on recovery
                        if self.journal is not None:
                            self.journal.hwm(rid, dedup.delivered)
                        writer.write(rec)
                    continue
                if ev in TERMINAL_EVENTS:
                    if ev == "rejected" \
                            and rec.get("reason") == REJECT_QUEUE_FULL:
                        return "queue_full", rec
                    writer.write(rec)
                    return ev, rec
                # non-terminal bookkeeping records pass through
                writer.write(rec)
        raise ConnectionError("replica stream ended without a terminal "
                              "event")

    # --------------------------------------------------------- resume

    def _resume(self, doc: dict, writer) -> threading.Thread | None:
        """Answer a client's `resume {request_id, next_index}` verb:
        find the original request (in-process memory from this life,
        the WAL orphan a previous life left, or the copy the client
        itself carried — in that order) and relay it again with the
        dedup floored at the client's own index. The client's count is
        authoritative: the journaled hwm may run one token ahead."""
        rid = str(doc.get("request_id") or "")
        try:
            next_index = max(0, int(doc.get("next_index", 0)))
        except (TypeError, ValueError):
            next_index = 0
        src: dict | None = None
        wal_line = self._resume_docs.get(rid) if rid else None
        if wal_line is not None:
            try:
                src = json.loads(wal_line)
            except json.JSONDecodeError:
                src = None
        if src is None and rid in self._recovered:
            orphan = self._recovered.pop(rid)
            src = orphan.doc
            wal_line = orphan.line if src is not None else None
        if src is None:
            carried = doc.get("request")
            if isinstance(carried, dict):
                src = dict(carried)
                src["id"] = rid
                wal_line = json.dumps(src, separators=(",", ":"))
        if not rid or not isinstance(src, dict):
            writer.write({"id": rid or None, "event": "rejected",
                          "reason": "unknown_request"})
            return None
        self.metrics.on_resume()
        self.tracer.event("route_resume", request=rid,
                          next_index=next_index,
                          router_life=self.router_life)
        self._log(f"[route] resuming {rid} from index {next_index}")
        with self._req_lock:
            self._active.add(rid)
        t = threading.Thread(
            target=self._relay, args=(rid, src, writer),
            kwargs={"resume_from": next_index, "wal_line": wal_line,
                    "as_resume": True, "hop_base": 1},
            name=f"resume-{rid}", daemon=True)
        t.start()
        self._req_threads.append(t)
        return t

    def recover_journal(self, writer=None) -> int:
        """Recover the previous router life's WAL. Socket mode
        (writer=None): orphans wait for their clients' resume verbs —
        the client's own index is the authoritative floor, and a
        pre-emptive re-dispatch would race the reconnect. JSONL mode:
        there is no reconnect (the pipe is the client), so orphans
        re-dispatch immediately, floored at the journaled hwm."""
        if self.journal is None:
            return 0
        orphans, clean = self.journal.recover()
        if not orphans:
            return 0
        self.metrics.on_orphans(len(orphans))
        for o in orphans:
            self.tracer.event("route_orphan_recovered", request=o.id,
                              replica=o.replica, hwm=o.hwm,
                              dispatches=o.dispatches)
        self._log(f"[route] WAL recovery: {len(orphans)} orphaned "
                  f"dispatch(es) from a previous router life")
        if writer is None:
            self._recovered = {o.id: o for o in orphans}
            return len(orphans)
        for o in orphans:
            src = o.doc
            if src is None:
                self.journal.done(o.id, "unrecoverable")
                continue
            self._resume_docs[o.id] = o.line
            with self._req_lock:
                self._active.add(o.id)
            t = threading.Thread(
                target=self._relay, args=(o.id, src, writer),
                kwargs={"resume_from": o.hwm, "wal_line": o.line,
                        "as_resume": True,
                        "hop_base": max(1, o.dispatches)},
                name=f"recover-{o.id}", daemon=True)
            t.start()
            self._req_threads.append(t)
        return len(orphans)

    # ------------------------------------------------------- shutdown

    def shutdown(self) -> dict:
        """Drain the fleet: SIGTERM every child (their own graceful
        drain finishes in-flight work and close-cleans the journal),
        join the supervisors, stop the monitor, stamp `router_end`."""
        self._stopping.set()

        def signal_children(kill: bool = False) -> None:
            for rep in self.replicas:
                proc = self._procs.get(rep.index)
                if proc is not None and proc.poll() is None:
                    try:
                        proc.kill() if kill else proc.terminate()
                    except OSError:
                        pass
                elif rep.adopted and rep.hb_pid:
                    # adopted from a previous router life: no Popen
                    # handle, signal by the heartbeat's pid
                    try:
                        os.kill(rep.hb_pid, signal.SIGKILL if kill
                                else signal.SIGTERM)
                    except (OSError, ProcessLookupError):
                        pass

        # a child may still be mid-spawn: wait briefly for every live
        # supervisor to register its Popen, or the signal pass below
        # misses it and the join runs out its whole budget before the
        # kill fallback can reach the late arrival
        t0 = self._clock()
        while self._clock() - t0 < 5.0 and any(
                t.is_alive() and self._procs.get(rep.index) is None
                for t, rep in zip(self._sup_threads, self.replicas)):
            time.sleep(0.05)
        signal_children()
        join_s = self.args.drain_timeout + 10.0
        t0 = self._clock()
        for t in self._sup_threads:
            t.join(timeout=max(0.5, join_s - (self._clock() - t0)))
        signal_children(kill=True)
        for t in self._sup_threads:
            t.join(timeout=5.0)
        self._mon_stop.set()
        if self._mon_thread is not None:
            self._mon_thread.join(timeout=5.0)
        if self._exporter is not None:
            self._exporter.close()
        if self.journal is not None:
            # clean only when nothing is owed: an in-flight stream at
            # hard-stop must survive as a WAL orphan for the next life
            if self.requests_idle:
                self.journal.close_clean()
            else:
                self.journal.close()
        summary = self.metrics.summary()
        summary["per_replica_restarts"] = {
            str(r.index): r.restarts for r in self.replicas}
        self.tracer.snapshot(self.metrics.reg)
        # the full summary rides the terminal event — nested per-replica
        # dicts included, they are what the bench probe reads back for
        # its fairness and affinity keys
        self.tracer.event("router_end", **summary)
        self.hb.close(phase="done",
                      dispatched=summary["dispatched"],
                      completed=summary["completed"])
        return summary


# --------------------------------------------------------- front-ends


def route_jsonl(router: Router, infile, outfile,
                drain=None, hard_stop=None) -> dict:
    """stdin/stdout mode: a reader thread feeds relay threads; the
    router drains on EOF (same composition contract as serve_jsonl —
    the smoke script pipes into it)."""
    out = _LineWriter(outfile)
    # a previous router life's orphans re-dispatch straight onto this
    # pipe — there is no per-client reconnect in JSONL mode, the hwm
    # floor is the only dedup boundary
    router.recover_journal(out)
    eof = threading.Event()

    def reader():
        try:
            for line in infile:
                line = line.strip()
                if not line:
                    continue
                router.submit_line(line, out)
        finally:
            eof.set()

    t = threading.Thread(target=reader, name="route-stdin", daemon=True)
    t.start()
    while True:
        if hard_stop is not None and hard_stop.is_set():
            router._hard_stop.set()
            break
        if drain is not None and drain.is_set():
            router.begin_drain()
        if eof.is_set() and router.requests_idle:
            break
        time.sleep(0.02)
    t.join(timeout=5)
    return router.shutdown()


def route_socket(router: Router, socket_path: str,
                 drain=None, hard_stop=None, ready=None) -> dict:
    """Unix-socket mode: each connection's requests relay back over its
    own writer — the same transport contract as serve_socket, one
    level up."""
    import socket as socket_mod
    import socketserver

    from hyperion_tpu_torch.serve.server import prepare_socket_path

    class _ChaosResetWriter:
        """conn_reset@p=X injection point: before each client write the
        chaos plan may raise ConnectionResetError; the handler then
        hard-closes the connection so the CLIENT sees the cut (EOF
        mid-stream) and exercises its resume path."""

        def __init__(self, writer, connection):
            self._w = writer
            self._conn = connection

        def write(self, rec) -> None:
            try:
                router.chaos.conn_reset("route_client_write")
            except ConnectionResetError:
                try:
                    self._conn.shutdown(socket_mod.SHUT_RDWR)
                    self._conn.close()
                except OSError:
                    pass
                raise
            self._w.write(rec)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            writer = _LineWriter(self.wfile)
            if router.chaos is not None and any(
                    f.kind == "conn_reset" for f in router.chaos.faults):
                writer = _ChaosResetWriter(writer, self.connection)
            mine: list[threading.Thread] = []
            for raw in self.rfile:
                try:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    t = router.submit_line(line, writer)
                    if t is not None:
                        mine.append(t)
                except Exception:  # noqa: BLE001 — a dead client's
                    break          # problem, never the router's
            for t in mine:
                t.join(timeout=router.args.stream_timeout)

    class Server(socketserver.ThreadingMixIn,
                 socketserver.UnixStreamServer):
        daemon_threads = True
        allow_reuse_address = True

        def handle_error(self, request, client_address):
            router.tracer.event("client_error",
                                client=str(client_address))

    # orphans from a previous life park in _recovered and wait for
    # their clients' resume verbs — BEFORE the socket opens, so a fast
    # reconnect cannot race the recovery scan
    router.recover_journal(None)
    # bind under the flock so a dying previous life's still-bound file
    # can never be probed/unlinked/rebound into a race
    srv = prepare_socket_path(socket_path,
                              bind=lambda: Server(socket_path, Handler))
    acceptor = threading.Thread(target=srv.serve_forever,
                                name="route-accept", daemon=True)
    acceptor.start()
    if ready is not None:
        ready.set()
    try:
        while True:
            if hard_stop is not None and hard_stop.is_set():
                router._hard_stop.set()
                break
            if drain is not None and drain.is_set():
                router.begin_drain()
                if router.requests_idle:
                    break
            time.sleep(0.05)
    finally:
        srv.shutdown()
        srv.server_close()
        try:
            Path(socket_path).unlink()
        except OSError:
            pass
    return router.shutdown()


# --------------------------------------------------------------- CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hyperion_tpu_torch.cli.main route",
        description="replica-tier serving: N supervised engine "
                    "replicas behind a health-aware, prefix-affine "
                    "router (stdin/JSONL by default, --socket for a "
                    "local unix socket)")
    p.add_argument("--replicas", type=int, default=2,
                   help="engine replicas to spawn and supervise")
    p.add_argument("--base-dir", default="data/router",
                   help="fleet root: replica_<i>/ holds each child's "
                        "socket, journal, telemetry, heartbeat; the "
                        "router's own telemetry.jsonl sits beside them "
                        "(`obs doctor <base-dir>` renders the fleet)")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="router front-end socket (default: stdin/stdout)")
    # ---- dispatch policy ----
    p.add_argument("--affinity-prefix", type=int, default=32,
                   help="prompt tokens hashed into the prefix-affinity "
                        "key: requests sharing this long a prefix (or a "
                        "session_id) stick to one replica so its radix "
                        "cache keeps hitting")
    p.add_argument("--affinity-slack", type=int, default=4,
                   help="load headroom an affinity target may carry "
                        "over the least-loaded replica before "
                        "stickiness yields")
    p.add_argument("--dispatch-timeout", type=float, default=60.0,
                   help="seconds a request may wait for a dispatchable "
                        "replica (renewed after a failover) before the "
                        "router rejects it")
    p.add_argument("--stream-timeout", type=float, default=300.0,
                   help="per-read socket timeout on a replica stream")
    # ---- fleet health ----
    p.add_argument("--stale-s", type=float, default=10.0,
                   help="heartbeat age that ejects a replica from "
                        "dispatch (readmission needs a fresh serve-"
                        "phase beat)")
    p.add_argument("--hang-timeout", type=float, default=60.0,
                   help="heartbeat age at which the supervisor SIGKILLs "
                        "a wedged child (0 = off)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="per-replica restart budget before its "
                        "supervisor gives up")
    p.add_argument("--ready-timeout", type=float, default=180.0,
                   help="seconds to wait for replicas to come up before "
                        "serving")
    p.add_argument("--min-ready", type=int, default=1,
                   help="replicas that must be READY before the router "
                        "starts accepting requests (deterministic "
                        "spread for drills/benches; default 1 = serve "
                        "as soon as anything can)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="graceful-drain window, router AND replicas")
    p.add_argument("--replica-chaos", action="append", default=None,
                   metavar="IDX:PLAN",
                   help="attach a chaos plan (testing/chaos.py grammar) "
                        "to one replica, e.g. 0:crash@tick=2 — the "
                        "kill-one-mid-stream drill")
    # ---- router crash safety (WAL + supervised failover) ----
    p.add_argument("--supervise", action="store_true",
                   help="run the router itself under the supervisor "
                        "core (heartbeat watchdog + restart budget): a "
                        "crashed router life restarts, re-adopts still-"
                        "live replicas, recovers the dispatch WAL, and "
                        "answers client resume verbs")
    p.add_argument("--router-journal", default="", metavar="PATH",
                   help="router WAL path (default: <base-dir>/"
                        "router_journal.jsonl; 'off' disables): every "
                        "dispatch + forwarded high-water mark, "
                        "recovered by the next router life")
    p.add_argument("--chaos", default="", metavar="PLAN",
                   help="router-scoped chaos plan (testing/chaos.py "
                        "grammar): crash@dispatch=N hard-exits the "
                        "router after its Nth placement, conn_reset@p=X "
                        "resets client wires probabilistically — the "
                        "router-death and stream-resume drills")
    # ---- acting on alerts (steer / class brownout / scale) ----
    p.add_argument("--act", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="act on replica SLO alerts: steer interactive "
                        "traffic off a TTFT-burning replica, order its "
                        "engine into a batch-class brownout, and (with "
                        "--max-replicas) scale standbys in and out "
                        "(--no-act = observe/tally only)")
    p.add_argument("--steer-clear-sweeps", type=int, default=3,
                   help="consecutive alert-free monitor sweeps before "
                        "a steered replica takes interactive traffic "
                        "again (unsteer hysteresis)")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="fleet ceiling for alert-driven scale-up "
                        "(standby replicas spawn while any replica "
                        "burns its TTFT budget, retire when the fleet "
                        "is quiet; 0 = no scaling)")
    # ---- replica engine surface (forwarded to each child) ----
    p.add_argument("--ckpt", required=True,
                   help="gathered-export .npz every replica serves")
    p.add_argument("--device", default="cuda",
                   help="torch device of every replica (the router "
                        "itself never touches one; --device cpu runs "
                        "the plain PyTorch path)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="every replica's compute dtype")
    p.add_argument("--tokenizer-dir", default="data/tokenizer")
    p.add_argument("--no-tokenizer", action="store_true")
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=0)
    p.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--host-cache-mb", type=int, default=0,
                   help="per-replica host-RAM KV spill tier "
                        "(serve/hostcache.py), forwarded to every "
                        "engine; replicas advertise hot prefix roots "
                        "on heartbeats and the dispatch policy steers "
                        "matching no-session requests to an "
                        "advertising replica within the affinity "
                        "slack (0 = off)")
    p.add_argument("--queue-capacity", type=int, default=64)
    p.add_argument("--prefill-budget", type=int, default=512)
    p.add_argument("--prefill-chunk", type=int, default=0)
    p.add_argument("--interactive-weight", type=int, default=3)
    p.add_argument("--batch-weight", type=int, default=1)
    p.add_argument("--batch-capacity", type=int, default=0)
    p.add_argument("--batch-deadline-s", type=float, default=0.0)
    p.add_argument("--max-new-default", type=int, default=32)
    p.add_argument("--warmup-lens", default="8,32")
    p.add_argument("--replica-heartbeat-every", type=int, default=5,
                   help="replica beat cadence in ticks — the router's "
                        "load scores are only as fresh as these beats")
    # ---- SLO burn-rate alerting (obs/slo.py) ----
    p.add_argument("--slo-ttft-p99-ms", type=float, default=0.0,
                   help="per-replica SLO target forwarded to every "
                        "engine (windowed TTFT p99 ceiling in ms; 0 = "
                        "off); firing alerts ride replica heartbeats "
                        "back into the router's fleet tally")
    p.add_argument("--slo-reject-rate", type=float, default=0.0,
                   help="reject-rate budget (0 = off): forwarded to "
                        "every engine AND evaluated router-level over "
                        "the fleet-wide relay outcomes (prefix "
                        "`route_` on the router's own alerts)")
    p.add_argument("--slo-availability", type=float, default=0.0,
                   help="per-replica availability floor forwarded to "
                        "every engine (0 = off)")
    p.add_argument("--slo-fast-s", type=float, default=0.0,
                   help="fast burn window seconds (0 = 60)")
    p.add_argument("--slo-slow-s", type=float, default=0.0,
                   help="slow burn window seconds (0 = 600)")
    return p


def supervise_route(argv: list[str], args) -> int:
    """`route --supervise`: the crash loop around the ROUTER —
    the same supervisor core the router wraps around its replicas, one
    level up. A dead router life restarts immediately (orphaned streams
    cost fleet throughput every second; the WAL makes the restart
    idempotent); a router whose heartbeat goes stale past
    --hang-timeout is SIGKILLed. The restarted life re-adopts still-
    live replicas from their heartbeats (no respawn), recovers the
    dispatch WAL, and answers the resume verbs of reconnecting
    clients. The reference consults `obs doctor` between lives; the
    port's doctor waits for ROADMAP A6, so the log says the verdict is
    unavailable."""
    from hyperion_tpu_torch.supervisor import (
        Decision,
        heartbeat_watchdog,
        run_child,
        strip_flags,
        supervise_loop,
    )

    def log(msg: str) -> None:
        # stderr, always: the router's stdout is the client wire
        print(msg, file=sys.stderr, flush=True)

    base = Path(args.base_dir)
    base.mkdir(parents=True, exist_ok=True)
    hb_path = str(base / "heartbeat.json")
    runner = run_child
    if args.hang_timeout > 0:
        runner = heartbeat_watchdog(hb_path, args.hang_timeout, log=log)

    def decide(rc: int) -> Decision:
        log(f"[route-supervisor] router exit {rc}; doctor verdict: "
            "unavailable; restarting — the new life re-adopts live "
            "replicas and recovers the dispatch WAL")
        return Decision.restart(immediate=True)

    child_argv = strip_flags(argv, {"--supervise"}, set())
    child = [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "route",
             *child_argv]
    return supervise_loop(child, decide=decide,
                          max_restarts=args.max_restarts,
                          run_child=runner, label="route-supervisor",
                          log=log)


def main(argv=None) -> int:
    import os
    import signal

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.supervise:
        return supervise_route(argv, args)

    from hyperion_tpu_torch.obs import heartbeat as obs_heartbeat
    from hyperion_tpu_torch.obs import trace as obs_trace

    base = Path(args.base_dir)
    base.mkdir(parents=True, exist_ok=True)
    # the router's stream defaults ON (it is the fleet's control-plane
    # record); HYPERION_TELEMETRY=0 still silences it. proc=0 skips the
    # dist lookup — the router must never touch the card.
    tracer = obs_trace.from_env(
        str(base / "telemetry.jsonl"),
        run=f"route_{int(SYSTEM.wall())}", proc=0, enabled_by_default=True)
    hb = obs_heartbeat.Heartbeat.for_tracer(tracer, every=25)
    router = Router(args, tracer, hb)
    router.start()
    need = max(1, min(args.min_ready, args.replicas))
    if not router.wait_ready(need, timeout_s=args.ready_timeout):
        print(f"[route] fewer than {need} replica(s) ready within "
              f"{args.ready_timeout:.0f}s — check "
              f"{base}/replica_*/telemetry.jsonl", file=sys.stderr)
        router._hard_stop.set()
        router.shutdown()
        tracer.close()
        return 3

    drain_evt = threading.Event()
    hard_evt = threading.Event()

    def _on_signal(signum, frame):
        if drain_evt.is_set():
            hard_evt.set()
        else:
            print(f"[route] signal {signum}: draining (signal again to "
                  "stop now)", file=sys.stderr)
        drain_evt.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass

    print(f"[route] {router.policy.ready_count}/{args.replicas} "
          f"replica(s) ready under {base}", file=sys.stderr)
    try:
        if args.socket:
            print(f"[route] listening on {args.socket}", file=sys.stderr)
            summary = route_socket(router, args.socket,
                                   drain=drain_evt, hard_stop=hard_evt)
        else:
            summary = route_jsonl(router, sys.stdin, sys.stdout,
                                  drain=drain_evt, hard_stop=hard_evt)
    except KeyboardInterrupt:
        summary = router.shutdown()
    print(f"[route] done: {summary['dispatched']} dispatched, "
          f"{summary['completed']} completed, "
          f"{summary['redispatched']} re-dispatched, "
          f"{summary['rejected']} rejected; per-replica "
          f"{summary['per_replica_dispatched']}", file=sys.stderr)
    tracer.close()
    if tracer.enabled:
        print(f"[route] fleet evidence under {base} (the reference's "
              "`obs doctor` and `obs trace --fleet` read it)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
