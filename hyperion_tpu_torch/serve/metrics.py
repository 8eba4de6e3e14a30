"""Serving gauges on the PR-1 obs registry — SLO numbers, not step numbers.

Training telemetry asks "how fast is the loop"; serving telemetry asks
"what does a user experience". The four canonical serving signals:

  * **TTFT** (time to first token) — submission → first emitted token,
    queue wait + prefill included. The interactive-feel number.
  * **TPOT** (time per output token) — inter-token gap during decode.
    The streaming-smoothness number.
  * **e2e latency** — submission → final token, p50/p95/p99.
  * **throughput + saturation** — aggregate tokens/sec, queue depth,
    slot occupancy, rejected/timed-out counts.

Everything lands in one `MetricsRegistry` (histograms carry
p50/p90/p95/p99 in every snapshot) and streams through the same tracer
records trainers use, so `obs summarize`, `obs doctor`, and `obs diff`
read serve runs with zero new parsers. The `tokens_per_s` gauge is
deliberately the SAME key the trainers publish: a serve run's
throughput rides every existing reader.
"""

from __future__ import annotations

from hyperion_tpu_torch.obs.registry import MetricsRegistry
from hyperion_tpu_torch.serve.queue import SLA_CLASSES
from hyperion_tpu_torch.utils.clock import SYSTEM


class ServeMetrics:
    """Serving instruments over one registry; the engine is the only
    writer, any tracer snapshot is the reader."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 clock=SYSTEM):
        self.reg = registry or MetricsRegistry()
        self._clock = clock
        self._t0 = clock()
        self._tokens = 0
        self._prefix_lookups = 0
        self._prefix_hits = 0
        # pre-create the lifecycle counters: a drained run that never
        # rejected anything should snapshot rejected=0, not omit the
        # key (absent evidence reads as "unknown" downstream)
        for name in ("serve_accepted", "serve_rejected",
                     "serve_timed_out", "serve_completed", "serve_ticks",
                     "serve_prefix_lookups", "serve_prefix_hits",
                     "serve_prefill_tokens_saved", "serve_preempted",
                     "serve_cow_copies", "serve_blocks_evicted",
                     # crash-safety + overload (journal/drain/brownout)
                     "serve_shed", "serve_brownout_clamped",
                     "serve_replayed", "serve_poisoned",
                     "serve_journal_errors", "serve_dropped_sinks",
                     # SLO burn-rate alerting (obs/slo.py): a run that
                     # never alerted must snapshot raised=0, not omit it
                     "serve_alerts_raised", "serve_alerts_cleared",
                     # speculative decoding (serve/draft.py + the
                     # engine's spec tick): drafted = accepted+rejected
                     "serve_spec_drafted", "serve_spec_accepted",
                     "serve_spec_rejected",
                     # compile ledger (obs/ledger.py): pinned at zero
                     # by the obs diff gate — any value > 0 is a broken
                     # recompile-free invariant
                     "serve_recompiles",
                     # tiered KV (serve/hostcache.py): every radix walk
                     # lands in exactly one tier bucket — host when the
                     # spill tier restored anything, device when only
                     # HBM blocks matched, miss otherwise
                     "serve_tier_hits_device", "serve_tier_hits_host",
                     "serve_tier_miss", "serve_host_spilled_blocks",
                     "serve_host_restored_blocks", "serve_spill_bytes",
                     "serve_restore_bytes"):
            self.reg.counter(name)
        # per-SLO-class lifecycle counters: the isolation contract is
        # judged from these (batch sheds while interactive sheds stay
        # 0), so every class/key pair must render even when untouched
        for cls in SLA_CLASSES:
            for stem in ("serve_accepted", "serve_completed",
                         "serve_shed", "serve_brownout_clamped"):
                self.reg.counter(f"{stem}_{cls}")
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._tick_tokens = 0
        self._ticks = 0
        self._tier_lookups = 0
        self._tier_host_hits = 0
        self._restore_bytes = 0
        # 0/1 flag, pre-set so "never browned out" snapshots as 0
        self.reg.gauge("serve_brownout_active").set(0.0)
        self.reg.gauge("serve_alerts_active").set(0.0)
        # router-ordered batch brownout (the `class_brownout` control
        # verb), distinct from the local governor's flag
        self.reg.gauge("serve_class_brownout").set(0.0)

    # -------------------------------------------------- admission edge

    def on_accept(self, sla_class: str | None = None) -> None:
        self.reg.counter("serve_accepted").inc()
        if sla_class:
            self.reg.counter(f"serve_accepted_{sla_class}").inc()

    def on_reject(self, reason: str) -> None:
        self.reg.counter("serve_rejected").inc()
        self.reg.counter(f"serve_rejected_{reason}").inc()

    def on_timeout(self) -> None:
        self.reg.counter("serve_timed_out").inc()

    def on_recompile(self, n: int = 1) -> None:
        """Post-warmup jit-cache growth (compile ledger `check`): n new
        executables appeared after the baseline was pinned."""
        self.reg.counter("serve_recompiles").inc(n)

    # ------------------------------------------------- per-request SLOs

    def on_first_token(self, req, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        ttft_ms = (now - req.submitted_at) * 1e3
        self.reg.histogram("ttft_ms").observe(ttft_ms)
        # per-class TTFT is the isolation number: interactive's tail
        # must hold while batch absorbs the hostile load
        self.reg.histogram(f"ttft_{req.sla_class}_ms").observe(ttft_ms)

    def on_token_gap(self, gap_s: float, sla_class: str | None = None,
                     ) -> None:
        self.reg.histogram("tpot_ms").observe(gap_s * 1e3)
        if sla_class:
            self.reg.histogram(f"tpot_{sla_class}_ms").observe(gap_s * 1e3)

    def on_finish(self, req, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        self.reg.counter("serve_completed").inc()
        self.reg.counter(f"serve_completed_{req.sla_class}").inc()
        self.reg.histogram("e2e_ms").observe(
            (now - req.submitted_at) * 1e3)

    def on_client_write(self, dur_s: float) -> None:
        """One transport-sink write (engine `_emit`): the time a slow
        client charges to its own request."""
        self.reg.histogram("client_write_ms").observe(dur_s * 1e3)

    def on_phases(self, req) -> None:
        """Per-phase totals of a finished request (engine
        `_on_finished`), from the canonical `Request.phases_s` mapping.
        client_write is skipped: its histogram (`client_write_ms`)
        observes individual sink writes via `on_client_write`, not
        per-request totals."""
        for name, v in req.phases_s().items():
            if name != "client_write":
                self.reg.histogram(f"{name}_ms").observe(v * 1e3)

    # -------------------------------------------------- paged KV cache

    def on_prefix_lookup(self, prompt_tokens: int, cached_tokens: int) -> None:
        """One radix walk at admission: `cached_tokens` of the
        `prompt_tokens`-long prompt came from shared blocks instead of
        prefill compute. The hit-rate gauge is the fraction of lookups
        that reused ANYTHING; tokens-saved is the prefill work that
        never ran — the number that turns into TTFT under a shared
        system prompt."""
        self._prefix_lookups += 1
        self.reg.counter("serve_prefix_lookups").inc()
        if cached_tokens > 0:
            self._prefix_hits += 1
            self.reg.counter("serve_prefix_hits").inc()
            self.reg.counter("serve_prefill_tokens_saved").inc(cached_tokens)
        self.reg.gauge("serve_prefix_hit_rate").set(
            self._prefix_hits / self._prefix_lookups)

    # ------------------------------------------ tiered KV (hostcache)

    def on_tier_lookup(self, device_tokens: int, host_tokens: int) -> None:
        """Tier attribution for one radix walk (engine `_admit`): the
        host bucket means the spill tier restored at least one block
        this admission — the copy that replaced a re-prefill. The
        host-hit-rate gauge is host hits over ALL lookups: the fraction
        of admissions the host tier personally rescued."""
        self._tier_lookups += 1
        if host_tokens > 0:
            self._tier_host_hits += 1
            self.reg.counter("serve_tier_hits_host").inc()
        elif device_tokens > 0:
            self.reg.counter("serve_tier_hits_device").inc()
        else:
            self.reg.counter("serve_tier_miss").inc()
        self.reg.gauge("serve_tier_hit_rate_host").set(
            self._tier_host_hits / self._tier_lookups)

    def on_host_spill(self, nbytes: int) -> None:
        """One block demoted device -> host (radix eviction's spill)."""
        self.reg.counter("serve_host_spilled_blocks").inc()
        self.reg.counter("serve_spill_bytes").inc(nbytes)

    def on_host_restore(self, blocks: int, nbytes: int) -> None:
        """One admission promoted `blocks` spilled blocks host ->
        device. The bytes/s gauge is the windowed restore bandwidth —
        the H2D cost the tier pays instead of re-prefill compute."""
        self.reg.counter("serve_host_restored_blocks").inc(blocks)
        self.reg.counter("serve_restore_bytes").inc(nbytes)
        self._restore_bytes += nbytes
        elapsed = self._clock() - self._t0
        if elapsed > 0:
            self.reg.gauge("serve_restore_bytes_per_s").set(
                self._restore_bytes / elapsed)

    def observe_host_cache(self, occupancy_mb: float, chains: int) -> None:
        """Host-tier occupancy after a spill or restore — the memory
        ledger's host-side sibling of blocks_in_use."""
        self.reg.gauge("serve_host_cache_mb").set(occupancy_mb)
        self.reg.gauge("serve_host_cache_chains").set(chains)

    def on_preempt(self) -> None:
        self.reg.counter("serve_preempted").inc()

    # ------------------------------------- crash safety + overload (PR 8)

    def on_shed(self, sla_class: str | None = None) -> None:
        """Brownout shed one deadline-doomed queued request."""
        self.reg.counter("serve_shed").inc()
        if sla_class:
            self.reg.counter(f"serve_shed_{sla_class}").inc()

    def on_clamp(self, sla_class: str | None = None) -> None:
        """Brownout clamped a new admission's max_new_tokens."""
        self.reg.counter("serve_brownout_clamped").inc()
        if sla_class:
            self.reg.counter(f"serve_brownout_clamped_{sla_class}").inc()

    def set_brownout(self, active: bool) -> None:
        self.reg.gauge("serve_brownout_active").set(1.0 if active else 0.0)

    def set_class_brownout(self, active: bool) -> None:
        """Router-ordered batch-class brownout (the PR-13 control-verb
        channel) — tracked apart from the local governor so the
        exposition payload can say WHO degraded the batch tier."""
        self.reg.gauge("serve_class_brownout").set(1.0 if active else 0.0)

    def on_replay(self) -> None:
        """One journaled request re-admitted at recovery."""
        self.reg.counter("serve_replayed").inc()

    def on_poisoned(self) -> None:
        """One request quarantined by the crash-replay poison rule."""
        self.reg.counter("serve_poisoned").inc()

    def on_journal_error(self) -> None:
        self.reg.counter("serve_journal_errors").inc()

    def on_dropped_sink(self) -> None:
        """A client died mid-stream; its sink was dropped."""
        self.reg.counter("serve_dropped_sinks").inc()

    def on_cow(self) -> None:
        self.reg.counter("serve_cow_copies").inc()

    def on_evict(self, n: int) -> None:
        self.reg.counter("serve_blocks_evicted").inc(n)

    def observe_cache(self, blocks_in_use: int, blocks_free: int,
                      active_reqs: int, block_bytes: int) -> None:
        """Cache-pressure gauges, refreshed every step. blocks_in_use
        near capacity with preemptions counting up = `--num-blocks`
        undersized; hbm_per_req_mb is the honest per-request memory
        cost AFTER sharing — the number the slab design could never
        report below slots x max_len."""
        self.reg.gauge("serve_blocks_in_use").set(blocks_in_use)
        self.reg.gauge("serve_blocks_free").set(blocks_free)
        if active_reqs:
            self.reg.gauge("serve_hbm_per_req_mb").set(
                blocks_in_use * block_bytes / active_reqs / 2**20)

    # ------------------------------------------------------- loop state

    def count_tokens(self, n: int) -> None:
        """Delivered-token accounting — tick emissions AND the
        prefill-sampled first token of each request (TTFT's token)
        both flow through here, so tokens_per_s matches what clients
        actually received."""
        if n:
            self._tokens += n
            self.reg.counter("tokens").inc(n)

    def on_tick(self, dur_s: float, tokens_emitted: int,
                slot_ticks: int | None = None) -> None:
        self.reg.counter("serve_ticks").inc()
        self.reg.histogram("serve_tick_ms").observe(dur_s * 1e3)
        self.count_tokens(tokens_emitted)
        # effective tokens per SLOT-tick (one live slot in one tick):
        # decode emissions over slot-ticks, prefill firsts excluded.
        # The sequential tick's ceiling is exactly 1.0 — anything
        # above is speculation actually landing, which is why the
        # bench/diff gate reads this gauge and not raw throughput
        self._ticks += slot_ticks if slot_ticks is not None \
            else tokens_emitted
        self._tick_tokens += tokens_emitted
        if self._ticks:
            self.reg.gauge("serve_tokens_per_tick").set(
                self._tick_tokens / self._ticks)

    def on_spec(self, drafted: int, accepted: int) -> None:
        """One slot's verify outcome this tick: `drafted` proposals
        entered the window, `accepted` survived the longest-prefix
        rule. The correction token is NOT counted — it's a normal
        decode token the sequential tick would also have produced,
        so accept_rate measures pure draft quality."""
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        self.reg.counter("serve_spec_drafted").inc(drafted)
        self.reg.counter("serve_spec_accepted").inc(accepted)
        self.reg.counter("serve_spec_rejected").inc(drafted - accepted)
        if self._spec_drafted:
            self.reg.gauge("serve_spec_accept_rate").set(
                self._spec_accepted / self._spec_drafted)

    def observe_state(self, queue_depth: int, slots_active: int,
                      n_slots: int) -> None:
        """Saturation gauges, refreshed every tick (cheap: three host
        floats). Occupancy near 1.0 with queue depth growing = scale
        out; occupancy low with rejections = prompt lengths exceed the
        cache, not capacity."""
        self.reg.gauge("queue_depth").set(queue_depth)
        self.reg.gauge("slots_active").set(slots_active)
        self.reg.gauge("slot_occupancy").set(
            slots_active / n_slots if n_slots else 0.0)
        elapsed = self._clock() - self._t0
        if elapsed > 0:
            # same key the trainers publish: every obs reader already
            # knows what tokens_per_s means
            self.reg.gauge("tokens_per_s").set(self._tokens / elapsed)

    # ---------------------------------------------------------- summary

    def summary(self) -> dict:
        """Host-side roll-up for the drain report / load generator."""
        snap = self.reg.snapshot()
        c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
        total = (c.get("serve_accepted", 0) + c.get("serve_rejected", 0))
        return {
            "accepted": int(c.get("serve_accepted", 0)),
            "rejected": int(c.get("serve_rejected", 0)),
            "timed_out": int(c.get("serve_timed_out", 0)),
            "completed": int(c.get("serve_completed", 0)),
            "reject_rate": (c.get("serve_rejected", 0) / total
                            if total else 0.0),
            "tokens": int(c.get("tokens", 0)),
            "tokens_per_s": g.get("tokens_per_s"),
            "ttft_ms": h.get("ttft_ms", {"count": 0}),
            "tpot_ms": h.get("tpot_ms", {"count": 0}),
            "e2e_ms": h.get("e2e_ms", {"count": 0}),
            # per-phase tail attribution (on_phases/on_client_write)
            "queue_wait_ms": h.get("queue_wait_ms", {"count": 0}),
            "gate_wait_ms": h.get("gate_wait_ms", {"count": 0}),
            "prefill_ms": h.get("prefill_ms", {"count": 0}),
            "decode_ms": h.get("decode_ms", {"count": 0}),
            "preempt_replay_ms": h.get("preempt_replay_ms", {"count": 0}),
            "client_write_ms": h.get("client_write_ms", {"count": 0}),
            "ticks": int(c.get("serve_ticks", 0)),
            # paged-cache pressure (serve/blocks.py)
            "prefix_lookups": int(c.get("serve_prefix_lookups", 0)),
            "prefix_hits": int(c.get("serve_prefix_hits", 0)),
            "prefix_hit_rate": g.get("serve_prefix_hit_rate", 0.0),
            "prefill_tokens_saved": int(
                c.get("serve_prefill_tokens_saved", 0)),
            "preempted": int(c.get("serve_preempted", 0)),
            "cow_copies": int(c.get("serve_cow_copies", 0)),
            "blocks_evicted": int(c.get("serve_blocks_evicted", 0)),
            # tiered KV (serve/hostcache.py): the device/host/miss
            # split plus the spill tier's own traffic
            "tier_hits_device": int(c.get("serve_tier_hits_device", 0)),
            "tier_hits_host": int(c.get("serve_tier_hits_host", 0)),
            "tier_miss": int(c.get("serve_tier_miss", 0)),
            "tier_hit_rate_host": g.get("serve_tier_hit_rate_host", 0.0),
            "host_spilled_blocks": int(
                c.get("serve_host_spilled_blocks", 0)),
            "host_restored_blocks": int(
                c.get("serve_host_restored_blocks", 0)),
            "restore_bytes": int(c.get("serve_restore_bytes", 0)),
            "restore_bytes_per_s": g.get("serve_restore_bytes_per_s",
                                         0.0),
            "host_cache_mb": g.get("serve_host_cache_mb", 0.0),
            "blocks_in_use": g.get("serve_blocks_in_use"),
            "hbm_per_req_mb": g.get("serve_hbm_per_req_mb"),
            # crash safety + overload (journal/drain/brownout)
            "shed": int(c.get("serve_shed", 0)),
            "brownout_clamped": int(c.get("serve_brownout_clamped", 0)),
            "brownout_active": bool(g.get("serve_brownout_active", 0.0)),
            "class_brownout": bool(g.get("serve_class_brownout", 0.0)),
            # per-SLO-class isolation roll-up: the drill's verdict keys
            "by_class": {
                cls: {
                    "accepted": int(c.get(f"serve_accepted_{cls}", 0)),
                    "completed": int(c.get(f"serve_completed_{cls}", 0)),
                    "shed": int(c.get(f"serve_shed_{cls}", 0)),
                    "clamped": int(
                        c.get(f"serve_brownout_clamped_{cls}", 0)),
                    "ttft_ms": h.get(f"ttft_{cls}_ms", {"count": 0}),
                    "tpot_ms": h.get(f"tpot_{cls}_ms", {"count": 0}),
                } for cls in SLA_CLASSES},
            "replayed": int(c.get("serve_replayed", 0)),
            "poisoned": int(c.get("serve_poisoned", 0)),
            "journal_errors": int(c.get("serve_journal_errors", 0)),
            "dropped_sinks": int(c.get("serve_dropped_sinks", 0)),
            # SLO burn-rate alerting (obs/slo.py)
            "alerts_raised": int(c.get("serve_alerts_raised", 0)),
            "alerts_cleared": int(c.get("serve_alerts_cleared", 0)),
            "alerts_active": int(g.get("serve_alerts_active") or 0),
            # speculative decoding (serve/draft.py + the spec tick):
            # accept_rate is None on a spec-disabled run (nothing was
            # ever drafted), never a misleading 0.0
            "spec_drafted": int(c.get("serve_spec_drafted", 0)),
            "spec_accepted": int(c.get("serve_spec_accepted", 0)),
            "spec_rejected": int(c.get("serve_spec_rejected", 0)),
            "accept_rate": g.get("serve_spec_accept_rate"),
            "tokens_per_tick": g.get("serve_tokens_per_tick"),
            # compile ledger (obs/ledger.py): the zero-pinned diff gate
            "recompiles": int(c.get("serve_recompiles", 0)),
        }


class RouterMetrics:
    """Fleet-level instruments for the replica router (serve/router.py)
    — same registry/snapshot discipline as ServeMetrics, different
    questions: not "how fast is one engine" but "how evenly is the
    fleet loaded, how sticky is affinity, and how often did health
    ejection fire". Unlike ServeMetrics (single engine-thread writer),
    these instruments are hit from MANY relay threads concurrently, so
    every mutation takes the lock — a lost increment here would skew
    the fairness/scaleup numbers bench reads back from router_end."""

    def __init__(self, registry: MetricsRegistry | None = None):
        import threading

        self.reg = registry or MetricsRegistry()
        self._lock = threading.Lock()
        for name in ("route_dispatched", "route_redispatched",
                     "route_rejected", "route_completed",
                     "route_affinity_lookups", "route_affinity_hits",
                     "replica_ejections", "replica_readmits",
                     # SLO alerting: the router's OWN burn-rate alerts
                     # (obs/slo.py publishes with prefix="route") plus
                     # the fleet tally of alerts its replicas report on
                     # their heartbeats — both pre-created so 0 renders
                     "route_alerts_raised", "route_alerts_cleared",
                     "fleet_alerts_raised",
                     # the acting router (alert-driven control): every
                     # steer/scale/brownout decision is counted so a
                     # flapping policy is visible as a number, not vibes
                     "router_steers", "router_unsteers",
                     "router_scale_up", "router_scale_down",
                     "class_brownouts_ordered",
                     "class_brownouts_lifted",
                     # router crash safety: client streams resumed
                     # across a disconnect, WAL orphans recovered by a
                     # new router life, replicas adopted (taken over
                     # live, no respawn) from a previous life
                     "route_resumes", "route_orphans_recovered",
                     "route_adopted",
                     # cache-aware routing (serve/hostcache.py): the
                     # dispatch went to a replica ADVERTISING the
                     # request's prefix root on its heartbeat — prefix
                     # locality without a session id
                     "route_cache_steered"):
            self.reg.counter(name)
        self.reg.gauge("fleet_ready").set(0.0)
        self.reg.gauge("fleet_inflight").set(0.0)
        self.reg.gauge("fleet_alerts_active").set(0.0)
        self.reg.gauge("route_alerts_active").set(0.0)
        self.reg.gauge("fleet_steered").set(0.0)

    def on_dispatch(self, replica: int, affinity_hit: bool,
                    had_key: bool, cache_hit: bool = False) -> None:
        with self._lock:
            self.reg.counter("route_dispatched").inc()
            self.reg.counter(f"route_dispatched_replica_{replica}").inc()
            if cache_hit:
                self.reg.counter("route_cache_steered").inc()
            if had_key:
                lookups = self.reg.counter("route_affinity_lookups")
                hits = self.reg.counter("route_affinity_hits")
                lookups.inc()
                if affinity_hit:
                    hits.inc()
                self.reg.gauge("route_affinity_hit_rate").set(
                    hits.value / lookups.value)

    def on_redispatch(self, reason: str) -> None:
        with self._lock:
            self.reg.counter("route_redispatched").inc()
            self.reg.counter(f"route_redispatched_{reason}").inc()

    def on_reject(self, reason: str) -> None:
        with self._lock:
            self.reg.counter("route_rejected").inc()
            self.reg.counter(f"route_rejected_{reason}").inc()

    def on_complete(self) -> None:
        with self._lock:
            self.reg.counter("route_completed").inc()

    def on_eject(self) -> None:
        with self._lock:
            self.reg.counter("replica_ejections").inc()

    def on_readmit(self) -> None:
        with self._lock:
            self.reg.counter("replica_readmits").inc()

    def observe_fleet(self, ready: int, inflight: int,
                      alerts_active: int | None = None) -> None:
        with self._lock:
            self.reg.gauge("fleet_ready").set(ready)
            self.reg.gauge("fleet_inflight").set(inflight)
            if alerts_active is not None:
                self.reg.gauge("fleet_alerts_active").set(alerts_active)

    def on_steer(self, on: bool) -> None:
        """One steering transition: `on` = interactive traffic moved
        OFF a burning replica, False = hysteresis-clean reversal."""
        with self._lock:
            self.reg.counter(
                "router_steers" if on else "router_unsteers").inc()

    def on_scale(self, up: bool) -> None:
        with self._lock:
            self.reg.counter(
                "router_scale_up" if up else "router_scale_down").inc()

    def on_class_brownout(self, on: bool) -> None:
        with self._lock:
            self.reg.counter("class_brownouts_ordered" if on
                             else "class_brownouts_lifted").inc()

    def observe_steered(self, n: int) -> None:
        with self._lock:
            self.reg.gauge("fleet_steered").set(n)

    def on_resume(self) -> None:
        """One client resume verb answered (reconnect after a wire cut
        or a router death)."""
        with self._lock:
            self.reg.counter("route_resumes").inc()

    def on_failover_gap(self, gap_s: float) -> None:
        """One failover gap closed: seconds from detecting a replica
        death mid-stream to the first record the client saw from the
        replacement (connect retries against the restart included)."""
        with self._lock:
            self.reg.histogram("route_failover_gap_ms").observe(
                max(0.0, gap_s) * 1000.0)

    def on_orphans(self, n: int) -> None:
        """`n` orphaned dispatches recovered from a previous router
        life's WAL."""
        if n:
            with self._lock:
                self.reg.counter("route_orphans_recovered").inc(n)

    def on_adopt(self) -> None:
        """One still-live replica adopted from a previous router life
        (taken over from its heartbeat, not respawned)."""
        with self._lock:
            self.reg.counter("route_adopted").inc()

    def on_fleet_alerts(self, n_new: int) -> None:
        """`n_new` alert names appeared on replica heartbeats since the
        last monitor sweep (serve/router.py counts the transitions —
        this is the fleet-wide raise tally bench's serving_scale row
        reads back from router_end)."""
        if n_new:
            with self._lock:
                self.reg.counter("fleet_alerts_raised").inc(n_new)

    def summary(self) -> dict:
        with self._lock:
            snap = self.reg.snapshot()
            gaps = self.reg.histogram("route_failover_gap_ms")
            failover_gap_p99_ms = (round(gaps.percentile(99), 3)
                                   if gaps.summary()["count"] else 0.0)
        c, g = snap["counters"], snap["gauges"]
        share = {
            k.removeprefix("route_dispatched_replica_"): int(v)
            for k, v in c.items()
            if k.startswith("route_dispatched_replica_")
        }
        return {
            "dispatched": int(c.get("route_dispatched", 0)),
            "redispatched": int(c.get("route_redispatched", 0)),
            "rejected": int(c.get("route_rejected", 0)),
            "completed": int(c.get("route_completed", 0)),
            "affinity_lookups": int(c.get("route_affinity_lookups", 0)),
            "affinity_hits": int(c.get("route_affinity_hits", 0)),
            "affinity_hit_rate": g.get("route_affinity_hit_rate"),
            "cache_steered": int(c.get("route_cache_steered", 0)),
            "ejections": int(c.get("replica_ejections", 0)),
            "readmits": int(c.get("replica_readmits", 0)),
            "per_replica_dispatched": share,
            # SLO alerting: router-local raises + the fleet tally of
            # replica-reported alerts (both ride router_end)
            "alerts_raised": int(c.get("route_alerts_raised", 0)),
            "fleet_alerts_raised": int(c.get("fleet_alerts_raised", 0)),
            "fleet_alerts_active": int(g.get("fleet_alerts_active") or 0),
            # the acting router: control decisions taken this run
            "steers": int(c.get("router_steers", 0)),
            "unsteers": int(c.get("router_unsteers", 0)),
            "scale_up": int(c.get("router_scale_up", 0)),
            "scale_down": int(c.get("router_scale_down", 0)),
            "class_brownouts": int(c.get("class_brownouts_ordered", 0)),
            "steered_now": int(g.get("fleet_steered") or 0),
            # router crash safety (rides router_end for bench/doctor)
            "resumes": int(c.get("route_resumes", 0)),
            "orphans_recovered": int(c.get("route_orphans_recovered", 0)),
            "adopted": int(c.get("route_adopted", 0)),
            # failover-gap tail (ms): 0.0 when no failover fired, so
            # the bench `serving_scale` row and the diff gate stay live
            # on healthy runs instead of going missing
            "failover_gap_p99_ms": failover_gap_p99_ms,
        }
