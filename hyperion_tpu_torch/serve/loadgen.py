"""Synthetic load generator — Poisson arrivals against the engine.

Serving numbers measured one request at a time are fiction: TTFT under
load includes queue wait, throughput under load includes slot
contention, and reject rate only exists when arrivals outpace drains.
This driver produces those conditions deterministically (seeded
arrival schedule, seeded prompt mix) and runs CLOSED-LOOP with the
engine: the driver and the serve loop share one thread, alternating
submit-due-requests with `engine.step()`, so a run is reproducible —
no wall-clock race decides which tick a request joins.

The port's copy of `hyperion_tpu/serve/loadgen.py`: the same specs give
the same workload (`build_workload`'s rng draw order is the
reference's), and the report carries the reference's keys
(`SERVING_REPORT_KEYS`), so either package's `obs diff` reads both.
`chip_smoke.py`'s `load` phase drives Llama-2-7B through `run_load`.
"""

from __future__ import annotations

import dataclasses
import time

from hyperion_tpu_torch.utils.clock import SYSTEM as _CLOCK

import numpy as np

from hyperion_tpu_torch.obs.export import DEFAULT_WINDOW_S
from hyperion_tpu_torch.obs.registry import percentile
from hyperion_tpu_torch.obs.timeline import PHASES, cohort_dominant
from hyperion_tpu_torch.serve.queue import (
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    SLA_CLASSES,
    Request,
)

# THE serving-row vocabulary: every key a `run_load` report carries
# that `obs diff`'s normalize() may consume. `scripts/check_diff_gates.py`
# cross-checks the gated metric names against this tuple so a gate can
# never outlive (or precede) the emitter that feeds it.
SERVING_REPORT_KEYS = (
    "requests", "completed", "rejected", "timed_out", "reject_rate",
    "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
    "e2e_p50_ms", "e2e_p99_ms", "elapsed_s", "arrival_rate_hz", "slots",
    "shared_prefix_tokens", "prefix_hit_rate", "prefill_tokens_saved",
    "preempted", "cow_copies", "blocks_in_use", "hbm_per_req_mb",
    "accept_rate", "tokens_per_tick", "spec_drafted", "spec_accepted",
    "spec_rejected", "shed", "brownout_clamped", "shed_rate",
    "clamp_rate",
    # tiered KV cache (serve/hostcache.py): where prefix
    # lookups landed (device radix / host spill tier / miss) and what
    # the host tier moved — the `rehit` workload's verdict keys
    "tier_hits_device", "tier_hits_host", "tier_miss",
    "tier_hit_rate_host", "restore_bytes_per_s", "host_cache_mb",
    *(f"{p}_p99_ms" for p in PHASES),
    "dominant_phase_p99", "ttft_p99_windowed_ms", "tpot_p99_windowed_ms",
    "alerts_raised", "alerts_active", "recompiles",
    # per-SLO-class isolation keys: the `@class` bench
    # dimension's verdict row — interactive latency must hold while
    # batch absorbs the sheds
    *(f"{cls}_{k}" for cls in SLA_CLASSES
      for k in ("ttft_p99_ms", "tpot_p99_ms", "completed", "shed",
                "shed_rate")),
)


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    n_requests: int = 32
    rate_hz: float = 50.0             # Poisson arrival rate
    prompt_lens: tuple[int, ...] = (4, 8, 16, 24)   # mixed, sampled
    max_new: tuple[int, ...] = (4, 8, 16)
    vocab: int = 256
    temperature: float = 0.0
    seed: int = 0
    deadline_s: float | None = None
    # > 0: every request's prompt starts with the SAME seeded
    # shared_prefix_tokens-long prefix (a system prompt), and
    # prompt_lens become the per-request TAIL lengths — the workload
    # shape that makes the engine's radix prefix cache earn its keep
    # (the first request prefills the prefix, every later one reuses
    # its blocks). The bench `serving` probe runs this mode.
    shared_prefix_tokens: int = 0
    # --- SLO-class mix ---
    # > 0: every batch_every-th request is class=batch — the mixed
    # workload the isolation drill and the bench `@class` dimension run
    batch_every: int = 0
    # --- adversarial tenant ---
    # one deterministic hostile tenant rides the base workload:
    #   burst     — its arrivals all collapse onto the first one (a
    #               thundering herd from one client)
    #   slowloris — its sinks sleep adversary_secs per token (a client
    #               that reads one byte at a time; in-process runs slow
    #               the sink, wire runs pair with the chaos clause)
    #   oversize  — its prompts balloon to adversary_prompt_len and it
    #               self-identifies as batch (the giant-prompt tenant
    #               chunked prefill exists for)
    # Shaping draws come from a SEPARATE rng AFTER the base draws, so
    # enabling a tenant never shifts the pinned base schedule.
    adversary: str = ""            # "" | burst | slowloris | oversize
    adversary_every: int = 0       # every Nth request is the tenant's
    adversary_secs: float = 0.05   # slowloris per-token stall
    adversary_prompt_len: int = 0  # oversize length (0 = 4x max base)
    # --- rehit churn (serve/hostcache.py) ---
    # > 0 (with shared_prefix_tokens): the tiered-KV drill shape. The
    # MIDDLE rehit_churn requests swap the shared prefix for DISTINCT
    # per-request prompts long enough to evict the shared chain from a
    # small device pool; the tail of the workload then re-asks for the
    # original prefix. With --host-cache-mb the re-hit restores from
    # the host spill tier (tier_hits_host > 0, prefill skipped); with
    # the tier off it is a full re-prefill — the delta `obs diff`
    # gates. Churn prompts come from their OWN rng (seed + 0x0C0C),
    # after the base draws, so enabling churn never shifts the pinned
    # base schedule (same discipline as the adversary shaping).
    rehit_churn: int = 0
    rehit_churn_len: int = 0       # churn prompt len (0 = prefix + max tail)


def request_id(seed: int, i: int) -> str:
    """Deterministic, seed-derived request id: the same spec produces
    the same ids run-to-run, so trace fixtures and bench attribution
    keys line up across rounds (and across machines)."""
    return f"load_s{seed}_{i:03d}"


def build_workload(spec: LoadSpec):
    """(arrivals, requests) for one spec — THE workload definition,
    shared by the in-process driver (`run_load`) and the socket-target
    driver (`run_load_socket`) so "the same spec" means the same
    arrival schedule, prompts, budgets, and seeds on either path. The
    rng draw ORDER is pinned (inter-arrivals, shared prefix, then per
    request: tail length, tail, budget, seed) — reordering it would
    silently shift every bench serving row across rounds."""
    rng = np.random.default_rng(spec.seed)
    inter = rng.exponential(1.0 / spec.rate_hz, spec.n_requests)
    arrivals = np.cumsum(inter)
    prefix = (rng.integers(1, spec.vocab, spec.shared_prefix_tokens)
              if spec.shared_prefix_tokens else None)

    def next_prompt() -> np.ndarray:
        tail = rng.integers(1, spec.vocab, rng.choice(spec.prompt_lens))
        return tail if prefix is None else np.concatenate([prefix, tail])

    # base draws first, ALL of them, in the pinned order — class and
    # adversary shaping below reads a separate rng, so the same seed
    # yields the same base workload whatever tenants ride along
    base = [(next_prompt(), int(rng.choice(spec.max_new)),
             int(rng.integers(0, 2**31 - 1)))
            for _ in range(spec.n_requests)]

    cls_of: dict[int, str] = {}
    tenant_of: dict[int, str] = {}
    prompt_of: dict[int, np.ndarray] = {}
    if spec.batch_every > 0:
        for i in range(spec.n_requests):
            if (i + 1) % spec.batch_every == 0:
                cls_of[i] = CLASS_BATCH
    if spec.adversary and spec.adversary_every > 0:
        arng = np.random.default_rng(spec.seed + 0x5EED)
        tenant = f"adv_{spec.adversary}"
        adv = [i for i in range(spec.n_requests)
               if (i + 1) % spec.adversary_every == 0]
        for i in adv:
            tenant_of[i] = tenant
        if spec.adversary == "burst" and adv:
            # thundering herd: every adversary arrival collapses onto
            # the tenant's first — the instant-queue-spike shape the
            # class-aware shed order must absorb batch-first
            arrivals = arrivals.copy()
            arrivals[adv] = arrivals[adv[0]]
        elif spec.adversary == "oversize":
            plen = spec.adversary_prompt_len \
                or 4 * max(spec.prompt_lens)
            for i in adv:
                prompt_of[i] = arng.integers(1, spec.vocab, plen)
                cls_of[i] = CLASS_BATCH
    if spec.rehit_churn > 0 and spec.shared_prefix_tokens:
        crng = np.random.default_rng(spec.seed + 0x0C0C)
        plen = spec.rehit_churn_len \
            or spec.shared_prefix_tokens + max(spec.prompt_lens)
        a = max(1, (spec.n_requests - spec.rehit_churn) // 2)
        for i in range(a, min(a + spec.rehit_churn, spec.n_requests)):
            prompt_of[i] = crng.integers(1, spec.vocab, plen)

    reqs = [
        Request(
            prompt_ids=prompt_of.get(i, base[i][0]),
            max_new_tokens=base[i][1],
            temperature=spec.temperature,
            seed=base[i][2],
            deadline_s=spec.deadline_s,
            id=request_id(spec.seed, i),
            sla_class=cls_of.get(i, CLASS_INTERACTIVE),
            tenant=tenant_of.get(i),
        )
        for i in range(spec.n_requests)
    ]
    return arrivals, reqs


def run_load(engine, spec: LoadSpec) -> dict:
    """Drive one load run to drain; return the serving report.

    Arrivals follow exponential inter-arrival times (a Poisson
    process) pre-drawn from `spec.seed`; prompt contents/lengths and
    decode budgets come from the same rng. Between engine steps the
    driver submits every request whose arrival time has passed —
    closed-loop, so a slow engine sees a burstier queue, exactly like
    a real ingress under fixed offered load."""
    arrivals, reqs = build_workload(spec)
    if spec.adversary == "slowloris" and spec.adversary_secs > 0:
        # the adversarial client that reads one byte at a time: its own
        # sink stalls on every token. The engine charges the stall to
        # the REQUEST's client_write phase (decode gaps are netted of
        # sink time), so the isolation claim — everyone else's TTFT and
        # TPOT hold — is measurable, not hopeful.
        def _slow_sink(rec, _secs=spec.adversary_secs):
            time.sleep(_secs)

        for r in reqs:
            if r.tenant is not None:
                r.sink = _slow_sink
    if spec.shared_prefix_tokens and hasattr(engine, "tracer"):
        # stamp the workload shape on the stream: `obs doctor` uses
        # this to call out a shared-prefix run whose hit counter
        # stayed at zero (a mis-configured prefix cache, not a slow one)
        engine.tracer.event("serve_workload",
                            shared_prefix_tokens=int(spec.shared_prefix_tokens),
                            n_requests=spec.n_requests)

    t0 = _CLOCK()
    submitted = 0
    rejected = 0
    while submitted < spec.n_requests or not engine.idle:
        now = _CLOCK() - t0
        while submitted < spec.n_requests and arrivals[submitted] <= now:
            ok, _reason = engine.submit(reqs[submitted])
            rejected += 0 if ok else 1
            submitted += 1
        if engine.idle:
            if submitted >= spec.n_requests:
                break  # tail request door-rejected with nothing in flight
            # nothing in flight: sleep to the next arrival instead of
            # spinning the scheduler
            nxt = arrivals[submitted] - (_CLOCK() - t0)
            if nxt > 0:
                time.sleep(min(nxt, 0.05))
            continue
        engine.step()
    elapsed = _CLOCK() - t0

    cache = engine.metrics.summary()
    done = [r for r in reqs if r.status == "done"]
    timed_out = sum(1 for r in reqs if r.status == "timed_out")
    ttft_ms = [
        (r.first_token_at - r.submitted_at) * 1e3
        for r in done if r.first_token_at is not None
    ]
    e2e_ms = [
        (r.finished_at - r.submitted_at) * 1e3
        for r in done if r.finished_at is not None
    ]
    tokens = sum(len(r.tokens) for r in done)

    # per-phase tail attribution over the completed requests (the same
    # numbers `request_finished` events carry; see obs/timeline.py for
    # the phase definitions) — p99s ride the bench serving row so
    # `obs diff` gates WHERE the tail went, not just how long it was
    def _p99_ms(vals) -> float | None:
        vals = [v for v in vals if v is not None]
        return round(percentile(vals, 99), 3) if vals else None

    attribution = {
        f"{p}_p99_ms": _p99_ms([r.phases_s()[p] * 1e3 for r in done])
        for p in PHASES
    }
    # dominant phase with COHORT semantics (the same math as obs
    # trace/doctor: average the requests at-or-beyond the e2e p99) —
    # the independent per-phase p99s above can each come from a
    # different request, and naming their max would let bench disagree
    # with the trace tools about the same run
    dominant = cohort_dominant(
        [r.finished_at - r.submitted_at for r in done],
        [r.phases_s() for r in done])

    # per-SLO-class verdict keys: client-observed TTFT per class (from
    # the requests' own stamps), TPOT p99 from the engine's per-class
    # histograms, and the shed split — the isolation drill's whole
    # claim is interactive_ttft holds while batch_shed absorbs the hit
    by_cls = cache.get("by_class") or {}
    per_class: dict = {}
    for cls in SLA_CLASSES:
        cdone = [r for r in done if r.sla_class == cls]
        cttft = [(r.first_token_at - r.submitted_at) * 1e3
                 for r in cdone if r.first_token_at is not None]
        tpot = (by_cls.get(cls) or {}).get("tpot_ms") or {}
        shed = int((by_cls.get(cls) or {}).get("shed", 0))
        n_cls = sum(1 for r in reqs if r.sla_class == cls)
        per_class[f"{cls}_ttft_p99_ms"] = (
            round(percentile(cttft, 99), 3) if cttft else None)
        per_class[f"{cls}_tpot_p99_ms"] = (
            round(tpot["p99"], 3)
            if isinstance(tpot.get("p99"), (int, float)) else None)
        per_class[f"{cls}_completed"] = len(cdone)
        per_class[f"{cls}_shed"] = shed
        per_class[f"{cls}_shed_rate"] = (
            round(shed / n_cls, 4) if n_cls else 0.0)

    return {
        **per_class,
        "requests": spec.n_requests,
        "completed": len(done),
        "rejected": rejected,
        "timed_out": timed_out,
        "reject_rate": round(rejected / spec.n_requests, 4)
        if spec.n_requests else 0.0,
        "tokens": tokens,
        "tokens_per_s": round(tokens / elapsed, 2) if elapsed > 0 else 0.0,
        "ttft_p50_ms": round(percentile(ttft_ms, 50), 3) if ttft_ms else None,
        "ttft_p99_ms": round(percentile(ttft_ms, 99), 3) if ttft_ms else None,
        "e2e_p50_ms": round(percentile(e2e_ms, 50), 3) if e2e_ms else None,
        "e2e_p99_ms": round(percentile(e2e_ms, 99), 3) if e2e_ms else None,
        "elapsed_s": round(elapsed, 3),
        "arrival_rate_hz": spec.rate_hz,
        "slots": engine.cfg.slots,
        "shared_prefix_tokens": spec.shared_prefix_tokens,
        # paged-cache pressure keys (engine metrics roll-up) — these
        # ride the bench `serving` row so `obs diff` gates cache
        # regressions exactly like throughput regressions
        **{k: cache.get(k)
           for k in ("prefix_hit_rate", "prefill_tokens_saved",
                     "preempted", "cow_copies", "blocks_in_use",
                     "hbm_per_req_mb")},
        # tiered KV cache (serve/hostcache.py): lookup tier split and
        # host-tier motion — the `rehit` workload's verdict keys, gated
        # by `obs diff` (hit rate higher-is-better, saved tokens delta)
        **{k: cache.get(k)
           for k in ("tier_hits_device", "tier_hits_host", "tier_miss",
                     "tier_hit_rate_host", "restore_bytes_per_s",
                     "host_cache_mb")},
        # speculative decoding (serve/draft.py): acceptance quality +
        # effective per-slot advance — `obs diff` gates both as
        # higher-is-better on spec-enabled rows (accept_rate is None
        # on a spec-off run, which diff treats as "not measured")
        "accept_rate": (round(cache["accept_rate"], 4)
                        if cache.get("accept_rate") is not None else None),
        "tokens_per_tick": (round(cache["tokens_per_tick"], 4)
                            if cache.get("tokens_per_tick") is not None
                            else None),
        "spec_drafted": cache.get("spec_drafted", 0),
        "spec_accepted": cache.get("spec_accepted", 0),
        "spec_rejected": cache.get("spec_rejected", 0),
        # overload brownout: shed/clamp events as rates so
        # `obs diff` gates them across rounds at any request count
        "shed": cache.get("shed", 0),
        "brownout_clamped": cache.get("brownout_clamped", 0),
        "shed_rate": round(cache.get("shed", 0) / spec.n_requests, 4)
        if spec.n_requests else 0.0,
        "clamp_rate": round(
            cache.get("brownout_clamped", 0) / spec.n_requests, 4)
        if spec.n_requests else 0.0,
        **attribution,
        "dominant_phase_p99": dominant,
        # live-plane keys: the WINDOWED p99s `obs top` shows —
        # over the engine's last-60s ring, which for a short probe run
        # is the whole run — and the SLO alert counters, so a bench
        # round that fired alerts says so on its serving row and
        # `obs diff` can gate serve_alerts_raised lower-is-better
        "ttft_p99_windowed_ms": _win_p99(engine, "ttft_ms"),
        "tpot_p99_windowed_ms": _win_p99(engine, "tpot_ms"),
        "alerts_raised": cache.get("alerts_raised", 0),
        "alerts_active": cache.get("alerts_active", 0),
        # compile ledger (obs/ledger.py): post-warmup graph growth
        # during the run — `obs diff` pins this at zero (ZERO_PINNED)
        "recompiles": cache.get("recompiles", 0),
    }


def _win_p99(engine, hist: str,
             window_s: float = DEFAULT_WINDOW_S) -> float | None:
    """Windowed p99 of one engine histogram (obs/registry.py ring) —
    None when the window saw nothing."""
    w = engine.metrics.reg.histogram(hist).windowed(window_s)
    p = w.get("p99")
    return round(p, 3) if isinstance(p, (int, float)) else None


def run_load_socket(socket_path: str, spec: LoadSpec, *,
                    request_timeout_s: float = 300.0,
                    session_every: int = 0) -> dict:
    """Drive a LIVE server or router over its unix socket with the same
    seeded workload `run_load` uses in-process — the real wire path:
    one connection per request, ServeClient connect-retry riding
    through any supervised restarts, client-side TTFT/e2e clocks.

    `session_every > 0` stamps `session_id = req_index // session_every`
    on each request, so a router in front gets a deterministic
    session-affinity workload to be sticky about.

    The report carries the client-observable subset of `run_load`'s
    keys (no engine internals — those belong to the server's own
    telemetry), so `obs diff` reads both shapes."""
    import threading

    from hyperion_tpu_torch.serve.client import ServeClient

    arrivals, reqs = build_workload(spec)
    results: list[dict] = [{} for _ in reqs]

    def drive(i: int) -> None:
        req = reqs[i]
        doc = {
            "id": req.id,
            "prompt_ids": np.asarray(req.prompt_ids).tolist(),
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "seed": int(req.seed),
        }
        if req.deadline_s is not None:
            doc["deadline_s"] = float(req.deadline_s)
        if req.sla_class != CLASS_INTERACTIVE:
            doc["class"] = req.sla_class
        if req.tenant is not None:
            doc["tenant"] = req.tenant
        if session_every > 0:
            doc["session_id"] = f"sess_{i // session_every}"
        # the wire-path slowloris: the tenant's own reader stalls
        # between records, starving its socket buffer exactly like a
        # real one-byte-at-a-time client
        stall = (spec.adversary_secs
                 if spec.adversary == "slowloris" and req.tenant
                 else 0.0)
        res = results[i]
        sent = _CLOCK()
        res["submitted_at"] = sent
        expected = 0  # next stream index owed — dup/gap audit
        try:
            with ServeClient(socket_path,
                             timeout_s=request_timeout_s) as c:
                for rec in c.stream(**doc):
                    ev = rec.get("event")
                    if stall > 0:
                        time.sleep(stall)
                    if ev == "token" and rec.get("token") is not None:
                        res.setdefault("first_token_at", _CLOCK())
                        res["tokens"] = res.get("tokens", 0) + 1
                        # exactly-once audit off the wire's stream
                        # index: an index below the expected one is a
                        # DUPLICATE delivery (a failover/resume dedup
                        # bug) — `obs diff` zero-pins the total
                        si = rec.get("i")
                        if isinstance(si, int):
                            if si < expected:
                                res["dup_tokens"] = \
                                    res.get("dup_tokens", 0) + 1
                            else:
                                expected = si + 1
                    elif ev in ("done", "rejected", "timed_out",
                                "error"):
                        res["status"] = ev
                        res["finished_at"] = _CLOCK()
                        # replica-attributed TTFT rides the done record
                        # (serve/server.py): client TTFT minus this is
                        # the time the router + wire owned the request
                        if isinstance(rec.get("ttft_ms"),
                                      (int, float)):
                            res["replica_ttft_ms"] = float(
                                rec["ttft_ms"])
        except (OSError, ConnectionError) as e:
            res["status"] = "error"
            res["error"] = repr(e)
            res["finished_at"] = _CLOCK()

    t0 = _CLOCK()
    threads: list[threading.Thread] = []
    for i in range(spec.n_requests):
        wait = t0 + arrivals[i] - _CLOCK()
        if wait > 0:
            time.sleep(wait)
        t = threading.Thread(target=drive, args=(i,),
                             name=f"load-{i}", daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=request_timeout_s)
    elapsed = _CLOCK() - t0

    done = [r for r in results if r.get("status") == "done"]
    ttft_ms = [(r["first_token_at"] - r["submitted_at"]) * 1e3
               for r in done if "first_token_at" in r]
    e2e_ms = [(r["finished_at"] - r["submitted_at"]) * 1e3
              for r in done if "finished_at" in r]
    # client-side windowed p99: requests whose first token landed in
    # the run's last exposition window — the socket driver cannot read
    # engine rings, so it computes the same "recent" view from its own
    # clocks
    cut = _CLOCK() - DEFAULT_WINDOW_S
    ttft_win = [(r["first_token_at"] - r["submitted_at"]) * 1e3
                for r in done
                if "first_token_at" in r and r["first_token_at"] >= cut]
    # router overhead the CLIENT observed: its own TTFT minus the
    # replica-attributed TTFT the done record carried. Everything the
    # router + wire added — placement, WAL, dispatch gap, relay copies
    # — and nothing the engine did. Directly comparable across fleet
    # sizes, and gated in `obs diff` as serve_router_overhead_p99_ms.
    overhead_ms = [
        max(0.0, (r["first_token_at"] - r["submitted_at"]) * 1e3
            - r["replica_ttft_ms"])
        for r in done
        if "first_token_at" in r and "replica_ttft_ms" in r]
    tokens = sum(r.get("tokens", 0) for r in done)
    rejected = sum(1 for r in results
                   if r.get("status") in ("rejected", "error"))
    return {
        "mode": "socket",
        "requests": spec.n_requests,
        "completed": len(done),
        "rejected": rejected,
        "timed_out": sum(1 for r in results
                         if r.get("status") == "timed_out"),
        "reject_rate": round(rejected / spec.n_requests, 4)
        if spec.n_requests else 0.0,
        "tokens": tokens,
        # exactly-once delivery audit: stream-indexed duplicates seen
        # across ALL requests (zero unless failover/resume dedup broke)
        "duplicate_tokens": sum(r.get("dup_tokens", 0) for r in results),
        "tokens_per_s": round(tokens / elapsed, 2) if elapsed > 0 else 0.0,
        "ttft_p50_ms": round(percentile(ttft_ms, 50), 3) if ttft_ms else None,
        "ttft_p99_ms": round(percentile(ttft_ms, 99), 3) if ttft_ms else None,
        "e2e_p50_ms": round(percentile(e2e_ms, 50), 3) if e2e_ms else None,
        "e2e_p99_ms": round(percentile(e2e_ms, 99), 3) if e2e_ms else None,
        "ttft_p99_windowed_ms": round(percentile(ttft_win, 99), 3)
        if ttft_win else None,
        "router_overhead_p99_ms": round(percentile(overhead_ms, 99), 3)
        if overhead_ms else None,
        "elapsed_s": round(elapsed, 3),
        "arrival_rate_hz": spec.rate_hz,
        "shared_prefix_tokens": spec.shared_prefix_tokens,
    }
