"""`obs trace --fleet <router_dir>` — cross-process fleet traces; a copy
of `hyperion_tpu/obs/fleet_trace.py` in the port.

A request's life now spans processes: client → router (possibly
several supervised lives) → replica A → crash → replica B → client
resume. `obs trace` (obs/timeline.py) reconstructs waterfalls from ONE
telemetry stream, so everything that happens BETWEEN processes —
router overhead, the dispatch→admit wire gap, the failover gap while a
replacement replica spins up, the resume gap while a client
reconnects — is invisible in every per-process p99 decomposition.

This module is the consumer of the hop context the router stamps on
every dispatched wire line (`{"trace": {"id", "hop", "attempt",
"router_life"}}` — serve/router.py) and every replica inherits onto
its `request_*` events (serve/engine.py). It discovers the fleet
layout the way `obs top` does (the router's stream at the base dir,
`replica_*/` telemetry dirs under it), joins router dispatch/
redispatch/resume spans with replica-side phase attribution per trace
id, and emits:

  * **One merged Chrome trace** — one track (pid) per process, the
    router's relay spans next to each replica's per-request waterfall,
    with Perfetto flow arrows for dispatch→admit, failover, and resume
    edges. All processes share the host wall clock, so `t_wall` is the
    join axis (per-process `t_mono` bases differ).
  * **Fleet tail attribution** — CLIENT-observed TTFT/e2e decomposed
    into router_overhead / dispatch_gap / replica phases /
    failover_gap / resume_gap (+ explicit `other`), cohort-averaged
    with the same exact-sum rule as `obs trace` per-process rows:
    `sum(components) + other == value` holds exactly.
  * **Named incidents** — the dominant cross-process component at p99
    becomes an `obs doctor` incident ("p99 e2e dominated by
    failover_gap — replica restarts too slow").

Degradation contract: missing replica dirs, torn streams, and
foreign-run heartbeats render PARTIAL traces with an explicit
`evidence_gaps` list — never a crash. Everything here is host-only
JSONL parsing: no torch, no devices.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from hyperion_tpu_torch.obs.registry import percentile
from hyperion_tpu_torch.obs.timeline import (
    PHASES,
    TTFT_PHASES,
    _cohort_row,
    _num,
    base_request_id,
    replica_of_run,
    requests_from_records,
)

# fleet attribution vocabulary, in journey order: the cross-process
# components bracket the per-process phase vocabulary they contain
FLEET_PHASES = ("router_overhead", "dispatch_gap") + PHASES \
    + ("failover_gap", "resume_gap")
FLEET_TTFT_PHASES = ("router_overhead", "dispatch_gap") + TTFT_PHASES

# dominant-component threshold for naming an incident — same bar as
# obs/doctor.py's per-process tail incidents
TAIL_DOMINANT_FRAC = 0.4

# router-stream event names this assembler consumes (the journey
# edges), and the replica-side lifecycle names it joins them to —
# scripts/check_event_vocab.py pins producers under serve/ against
# this consumer vocabulary:
#   route_dispatch, route_redispatch, route_resume, route_complete,
#   route_orphan_recovered, router_start, router_end, router_draining,
#   router_steer, router_scale, class_brownout, replica_ready,
#   replica_ejected, replica_readmitted, replica_adopted, replica_exit,
#   replica_alert, request_admitted, request_scheduled, request_requeued,
#   request_first_token, request_preempted, request_finished,
#   request_rejected, request_timeout, request_poisoned,
#   prefill_chunked, stream_resume, client_disconnected, client_error,
#   journal_replayed, journal_io_error, serve_start, serve_draining,
#   drain_timeout, serve_warmup_done, serve_workload, compile_ledger,
#   recompile_after_warmup, brownout_enter, brownout_exit,
#   profile_requested


class _Shim:
    """Value + component carrier for `_cohort_row` (it reads
    `.phases`)."""

    __slots__ = ("value", "phases")

    def __init__(self, value: float, phases: dict):
        self.value = value
        self.phases = phases


# ----------------------------------------------------------- discovery


def discover(base: Path) -> tuple[Path | None, list[Path]]:
    """Fleet layout under a router base dir, the way `obs top` walks
    it: the router's own telemetry at the base, `replica_*/` children
    numerically sorted."""
    router = base / "telemetry.jsonl"
    reps = sorted(
        (d for d in base.glob("replica_*") if d.is_dir()),
        key=lambda d: (not d.name.split("_", 1)[1].isdigit(),
                       int(d.name.split("_", 1)[1])
                       if d.name.split("_", 1)[1].isdigit() else 0,
                       d.name))
    return (router if router.exists() else None), reps


def _replica_index(d: Path) -> int | None:
    tail = d.name.split("_", 1)[1] if "_" in d.name else ""
    return int(tail) if tail.isdigit() else None


# ------------------------------------------------------------ assembly


def _wall(r: dict) -> float | None:
    return _num(r.get("t_wall"))


def assemble(base: Path, run: str | None = None) -> dict | None:
    """Join the router stream with every replica stream per trace id.

    Returns the assembled fleet dict (see module docstring) or None
    when the base dir has no router telemetry at all. Joins span ALL
    router lives on the stream (a supervised router-crash drill's
    whole story is one trace) unless `run` pins one."""
    from hyperion_tpu_torch.obs.report import read_records

    router_path, rep_dirs = discover(base)
    gaps: list[str] = []
    if router_path is None:
        return None
    router_recs = [r for r in read_records(router_path)
                   if run is None or r.get("run") == run]
    router_runs = sorted({r.get("run") for r in router_recs
                          if r.get("run")})
    if not rep_dirs:
        gaps.append(f"no replica_*/ telemetry dirs under {base}")

    # --- replica side: per-leg lifecycle anchors on the wall clock.
    # legs[(replica, base_id)] -> sorted list of admit anchors; each
    # anchor carries the leg's RequestTrace for phase attribution.
    legs: dict[tuple[int, str], list[dict]] = {}
    replicas_seen: dict[int, dict] = {}
    for d in rep_dirs:
        idx = _replica_index(d)
        tele = d / "telemetry.jsonl"
        if not tele.exists():
            gaps.append(f"{d.name}: no telemetry.jsonl (replica "
                        "evidence missing)")
            continue
        recs = read_records(tele)
        runs_seen: dict[str, None] = {}
        for r in recs:
            if r.get("request") and r.get("run"):
                runs_seen.setdefault(r["run"], None)
        hb = d / "heartbeat.json"
        if hb.exists():
            try:
                hb_run = json.loads(hb.read_text()).get("run")
            except (OSError, json.JSONDecodeError):
                hb_run = None
            if hb_run and runs_seen and hb_run not in runs_seen \
                    and hb_run not in {r.get("run") for r in recs}:
                gaps.append(f"{d.name}: heartbeat.json names foreign "
                            f"run {hb_run!r} — stream may be from "
                            "another deployment")
        replicas_seen[idx if idx is not None else -1] = {
            "dir": d.name, "runs": list(runs_seen)}
        for rrun in runs_seen:
            ridx = replica_of_run(rrun)
            ridx = ridx if ridx is not None else idx
            # wall offset for this process life: every record carries
            # both clocks, so mono-denominated segments convert exactly
            off = None
            for r in recs:
                if r.get("run") == rrun and _wall(r) is not None \
                        and _num(r.get("t_mono")) is not None:
                    off = r["t_wall"] - r["t_mono"]
                    break
            traces = {t.id: t for t in
                      requests_from_records(recs, run=rrun)}
            for r in recs:
                if r.get("run") != rrun or r.get("kind") != "event" \
                        or not r.get("request"):
                    continue
                bid = base_request_id(str(r["request"]))
                if r.get("name") == "request_admitted":
                    ctx = r.get("trace") \
                        if isinstance(r.get("trace"), dict) else None
                    legs.setdefault((ridx, bid), []).append({
                        "run": rrun, "replica": ridx,
                        "admit_wall": _wall(r),
                        "wire_id": str(r["request"]),
                        "ctx": ctx, "off": off,
                        "trace": traces.get(bid),
                        "first_token": None,
                    })
                elif r.get("name") == "request_first_token":
                    # keep the event's OWN wait/prefill split with the
                    # leg: a leg that dies mid-stream never writes
                    # request_finished, and the client's TTFT came
                    # from THIS leg regardless of who finishes later
                    anchors = legs.get((ridx, bid), [])
                    if anchors and anchors[-1]["first_token"] is None:
                        anchors[-1]["first_token"] = {
                            "wall": _wall(r),
                            "queue_wait":
                                _num(r.get("queue_wait_s")) or 0.0,
                            "gate_wait":
                                _num(r.get("gate_wait_s")) or 0.0,
                            "prefill": _num(r.get("prefill_s")) or 0.0,
                        }
    for anchors in legs.values():
        anchors.sort(key=lambda a: a["admit_wall"] or 0.0)

    # --- router side: journey edges per trace id, in stream order
    journeys: dict[str, dict] = {}
    for r in router_recs:
        if r.get("kind") != "event" or not r.get("request"):
            continue
        name = r.get("name")
        if name not in ("route_dispatch", "route_redispatch",
                        "route_resume", "route_complete",
                        "route_orphan_recovered"):
            continue
        bid = base_request_id(str(r["request"]))
        j = journeys.setdefault(bid, {
            "id": bid, "dispatches": [], "redispatches": [],
            "resumes": [], "completes": []})
        key = {"route_dispatch": "dispatches",
               "route_redispatch": "redispatches",
               "route_resume": "resumes",
               "route_complete": "completes"}.get(name)
        if key is not None:
            j[key].append(r)

    # --- classify every dispatch edge and join it to its admit
    requests: list[dict] = []
    for bid, j in sorted(journeys.items()):
        edges: list[dict] = []
        matched: set[int] = set()  # admit anchors already consumed
        for disp in sorted(j["dispatches"],
                           key=lambda r: _wall(r) or 0.0):
            ctx = disp.get("trace") if isinstance(disp.get("trace"),
                                                 dict) else {}
            hop = ctx.get("hop")
            attempt = ctx.get("attempt",
                              disp.get("redispatch"))
            kind = "dispatch"
            if isinstance(attempt, int) and attempt > 0:
                kind = "failover"
            elif isinstance(hop, int) and isinstance(attempt, int) \
                    and hop > attempt:
                kind = "resume"
            dw = _wall(disp)
            rep = disp.get("replica")
            anchor = None
            for i, a in enumerate(legs.get((rep, bid), [])):
                if id(a) in matched or a["admit_wall"] is None:
                    continue
                # same-host wall clock: a 1 ms slack absorbs rounding
                if dw is None or a["admit_wall"] >= dw - 0.001:
                    anchor = a
                    matched.add(id(a))
                    break
            if anchor is None and rep is not None:
                gaps.append(
                    f"{kind} of {bid} to replica {rep} has no matching "
                    "request_admitted (replica stream missing or torn)")
            edges.append({"kind": kind, "wall": dw, "replica": rep,
                          "ctx": ctx, "anchor": anchor,
                          "redispatch_from": None})
        # pair each failover edge with the route_redispatch that
        # triggered it (the failure-detection instant starts the gap)
        redis = sorted(j["redispatches"], key=lambda r: _wall(r) or 0.0)
        ri = 0
        for e in edges:
            if e["kind"] != "failover":
                continue
            while ri < len(redis) and (
                    e["wall"] is None or _wall(redis[ri]) is None
                    or _wall(redis[ri]) <= e["wall"]):
                e["redispatch_from"] = _wall(redis[ri])
                ri += 1
        resumes = sorted(j["resumes"], key=lambda r: _wall(r) or 0.0)
        completes = sorted(j["completes"], key=lambda r: _wall(r) or 0.0)

        # --- journey value: client-observed e2e. A single-relay journey
        # IS a route_complete: its measured e2e_s is used verbatim (the
        # exact-sum pin holds against the router's own number, not a
        # reconstruction). Multi-relay journeys — a resume means the
        # first relay ended without completing — span relays on the
        # shared wall clock from the earliest observable intake.
        comps = {p: 0.0 for p in FLEET_PHASES}
        value = ttft_value = None
        submit_wall = first_dispatch = None
        last_complete = completes[-1] if completes else None
        if edges:
            first_dispatch = edges[0]["wall"]
        multi_relay = bool(resumes) or len(completes) > 1
        if completes:
            c0 = completes[0]
            e2e0 = _num(c0.get("e2e_s"))
            if e2e0 is not None and _wall(c0) is not None:
                submit_wall = _wall(c0) - e2e0
        if first_dispatch is not None and (
                submit_wall is None
                or (multi_relay and first_dispatch < submit_wall)):
            # relays before the completing one left no measured intake:
            # the first placement is the earliest observable instant
            submit_wall = first_dispatch
        if last_complete is not None and submit_wall is not None \
                and _wall(last_complete) is not None:
            if not multi_relay:
                value = _num(last_complete.get("e2e_s"))
            if value is None:
                value = max(0.0, _wall(last_complete) - submit_wall)
        # router_overhead: relay intake -> first placement
        if submit_wall is not None and first_dispatch is not None:
            comps["router_overhead"] = max(
                0.0, first_dispatch - submit_wall)
        # gap components off the classified edges
        for e in edges:
            a = e["anchor"]
            if a is None or a["admit_wall"] is None:
                continue
            if e["kind"] == "dispatch" and e["wall"] is not None:
                comps["dispatch_gap"] += max(
                    0.0, a["admit_wall"] - e["wall"])
            elif e["kind"] == "failover":
                start = e["redispatch_from"] \
                    if e["redispatch_from"] is not None else e["wall"]
                if start is not None:
                    comps["failover_gap"] += max(
                        0.0, a["admit_wall"] - start)
            elif e["kind"] == "resume":
                start = None
                for rr in resumes:
                    w = _wall(rr)
                    if w is not None and (e["wall"] is None
                                          or w <= e["wall"]):
                        start = w
                if start is None:
                    start = e["wall"]
                if start is not None:
                    comps["resume_gap"] += max(
                        0.0, a["admit_wall"] - start)
        # replica phases: the COMPLETING leg's attribution (earlier
        # legs' partial work is failover cost, not client-visible time)
        final_leg = None
        if last_complete is not None:
            rep = last_complete.get("replica")
            cands = [e["anchor"] for e in edges
                     if e["anchor"] is not None
                     and (rep is None or e["replica"] == rep)]
            final_leg = cands[-1] if cands else None
        if final_leg is None and edges:
            cands = [e["anchor"] for e in edges
                     if e["anchor"] is not None]
            final_leg = cands[-1] if cands else None
        rt = final_leg["trace"] if final_leg else None
        if rt is not None and rt.phases:
            for p in PHASES:
                comps[p] = rt.phases.get(p, 0.0)
        elif last_complete is not None and final_leg is None:
            gaps.append(f"{bid}: completed on the wire but no replica "
                        "leg found — phases unattributed")
        # client-observed TTFT: submit -> the EARLIEST first-token
        # instant any leg produced (the client saw that token even if
        # a later leg did the finishing). The split comes from the
        # first_token event's own payload — a leg that dies mid-stream
        # never finalizes phases in request_finished
        ft = None
        for e in edges:
            a = e["anchor"]
            if a is not None and a["first_token"] is not None \
                    and a["first_token"]["wall"] is not None:
                if ft is None or a["first_token"]["wall"] < ft["wall"]:
                    ft = a["first_token"]
        if ft is not None and submit_wall is not None:
            ttft_value = max(0.0, ft["wall"] - submit_wall)
        ttft_comps = None
        if ttft_value is not None:
            ttft_comps = {
                "router_overhead": comps["router_overhead"],
                "dispatch_gap": comps["dispatch_gap"],
                **{p: ft.get(p, 0.0) for p in TTFT_PHASES},
            }
        requests.append({
            "id": bid,
            "status": (last_complete.get("status")
                       if last_complete is not None else "incomplete"),
            "submit_wall": submit_wall,
            "finish_wall": _wall(last_complete)
            if last_complete is not None else None,
            "e2e_s": value,
            "ttft_s": ttft_value,
            "components_s": comps,
            "ttft_components_s": ttft_comps,
            "n_dispatches": len(edges),
            "n_failovers": sum(1 for e in edges
                               if e["kind"] == "failover"),
            "n_resumes": sum(1 for e in edges if e["kind"] == "resume"),
            "edges": edges,
            "final_leg": final_leg,
        })

    if not journeys:
        gaps.append("router stream carries no route_dispatch events — "
                    "nothing to join")
    return {
        "base": str(base),
        "router_runs": router_runs,
        "replicas": replicas_seen,
        "requests": requests,
        "evidence_gaps": gaps,
        "_router_records": router_recs,
        "_legs": legs,
    }


# -------------------------------------------------------- attribution


def attribution(asm: dict,
                quantiles: tuple[int, ...] = (50, 99)) -> dict:
    """Fleet tail rows with the per-process exact-sum rule: each row
    averages the at-or-beyond-quantile cohort, components averaged the
    same way, `other` the exact remainder."""
    reqs = asm["requests"]
    done = [r for r in reqs
            if r["status"] == "done" and r["e2e_s"] is not None]
    rows: list[dict] = []
    for metric, phases, pick in (
        ("ttft", FLEET_TTFT_PHASES,
         lambda r: (r["ttft_s"], r["ttft_components_s"])),
        ("e2e", FLEET_PHASES,
         lambda r: (r["e2e_s"], r["components_s"])),
    ):
        shims = [_Shim(v, c) for v, c in (pick(r) for r in done)
                 if v is not None and c is not None]
        if not shims:
            continue
        vals = [s.value for s in shims]
        for q in quantiles:
            cut = percentile(vals, q)
            cohort = [s for s in shims if s.value >= cut] \
                or [max(shims, key=lambda s: s.value)]
            rows.append(_cohort_row(metric, q, cohort, phases,
                                    lambda s: s.value))
    return {"requests": len(reqs), "completed": len(done), "rows": rows}


def tail_incidents(rows: list[dict]) -> list[str]:
    """Named cross-process incidents from the p99 rows — the doctor's
    fleet-trace vocabulary. Replica-side dominants are left to the
    per-process tail analysis (it knows the engine knobs)."""
    out: list[str] = []
    for row in rows:
        if row.get("q") != 99 or not row.get("dominant"):
            continue
        if (row.get("dominant_frac") or 0.0) < TAIL_DOMINANT_FRAC:
            continue
        dom = row["dominant"]
        where = (f"{row['components_ms'].get(dom, row['other_ms'])}"
                 f" of {row['value_ms']} ms")
        metric = row["metric"]
        if dom == "failover_gap":
            out.append(f"p99 {metric} dominated by failover_gap "
                       f"({where}) — replica restarts too slow for the "
                       "failover path")
        elif dom == "dispatch_gap":
            out.append(f"p99 {metric} dominated by dispatch_gap "
                       f"({where}) — router thread-per-relay saturated "
                       "or replica intake stalled")
        elif dom == "router_overhead":
            out.append(f"p99 {metric} dominated by router_overhead "
                       f"({where}) — placement/WAL path slow on the "
                       "router")
        elif dom == "resume_gap":
            out.append(f"p99 {metric} dominated by resume_gap "
                       f"({where}) — clients reconnect slowly after "
                       "failover")
    return list(dict.fromkeys(out))


# ------------------------------------------------------ Chrome export


def chrome_fleet_trace(asm: dict) -> dict:
    """One merged Chrome trace-event JSON: pid 0 = router, pid i+1 =
    replica i, per-request tracks inside each process, and Perfetto
    flow arrows ("s"/"f" pairs sharing an id) for every dispatch→admit,
    failover, and resume edge. The wall clock is the shared axis."""
    t0 = None
    for r in asm["requests"]:
        for cand in (r["submit_wall"], r["finish_wall"]):
            if cand is not None:
                t0 = cand if t0 is None else min(t0, cand)
        for e in r["edges"]:
            if e["wall"] is not None:
                t0 = e["wall"] if t0 is None else min(t0, e["wall"])
            a = e["anchor"]
            if a is not None and a["admit_wall"] is not None:
                t0 = a["admit_wall"] if t0 is None \
                    else min(t0, a["admit_wall"])
    t0 = t0 or 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    ev: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "hyperion route"}},
    ]
    rep_pids: dict[int, int] = {}
    for idx in sorted(k for k in asm["replicas"] if k >= 0):
        pid = idx + 1
        rep_pids[idx] = pid
        ev.append({"name": "process_name", "ph": "M", "pid": pid,
                   "tid": 0,
                   "args": {"name": f"hyperion serve replica_{idx}"}})

    # replica-side request tracks: every joined leg's waterfall
    # segments, mono->wall converted with its process-life offset
    leg_tids: dict[int, dict[str, int]] = {}
    for (ridx, bid), anchors in sorted(asm["_legs"].items(),
                                       key=lambda kv: str(kv[0])):
        pid = rep_pids.get(ridx)
        if pid is None:
            continue
        tids = leg_tids.setdefault(ridx, {})
        if bid not in tids:
            tids[bid] = len(tids) + 1
            ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tids[bid],
                       "args": {"name": f"req {bid}"}})
        tid = tids[bid]
        for a in anchors:
            rt, off = a["trace"], a["off"]
            if rt is None or off is None:
                continue
            for name, t, dur in rt.segments:
                ev.append({"name": name, "ph": "X", "pid": pid,
                           "tid": tid, "ts": us(t + off),
                           "dur": round(dur * 1e6, 1),
                           "args": {"request": bid,
                                    "wire_id": a["wire_id"]}})
            for name, t in rt.marks:
                ev.append({"name": name, "ph": "i", "s": "t",
                           "pid": pid, "tid": tid, "ts": us(t + off),
                           "args": {"request": bid}})

    # router-side relay tracks + flow arrows
    flow = 0
    for i, r in enumerate(sorted(asm["requests"],
                                 key=lambda x: x["submit_wall"] or 0.0)):
        tid = i + 1
        ev.append({"name": "thread_name", "ph": "M", "pid": 0,
                   "tid": tid,
                   "args": {"name": f"req {r['id']} [{r['status']}]"}})
        if r["submit_wall"] is not None and r["finish_wall"] is not None:
            ev.append({"name": "relay", "ph": "X", "pid": 0, "tid": tid,
                       "ts": us(r["submit_wall"]),
                       "dur": round((r["finish_wall"]
                                     - r["submit_wall"]) * 1e6, 1),
                       "args": {"request": r["id"],
                                "status": r["status"],
                                "failovers": r["n_failovers"],
                                "resumes": r["n_resumes"]}})
        for e in r["edges"]:
            if e["wall"] is None:
                continue
            name = {"dispatch": "route_dispatch",
                    "failover": "route_failover",
                    "resume": "route_resume"}[e["kind"]]
            ev.append({"name": name, "ph": "i", "s": "p", "pid": 0,
                       "tid": tid, "ts": us(e["wall"]),
                       "args": {"request": r["id"],
                                "replica": e["replica"],
                                **({"trace": e["ctx"]}
                                   if e["ctx"] else {})}})
            a = e["anchor"]
            if a is None or a["admit_wall"] is None:
                continue
            pid = rep_pids.get(a["replica"])
            tid2 = leg_tids.get(a["replica"], {}).get(r["id"])
            if pid is None or tid2 is None:
                continue
            flow += 1
            ev.append({"name": e["kind"], "cat": "fleet", "ph": "s",
                       "id": flow, "pid": 0, "tid": tid,
                       "ts": us(e["wall"]),
                       "args": {"request": r["id"]}})
            ev.append({"name": e["kind"], "cat": "fleet", "ph": "f",
                       "bp": "e", "id": flow, "pid": pid, "tid": tid2,
                       "ts": us(a["admit_wall"]),
                       "args": {"request": r["id"]}})
    return {"displayTimeUnit": "ms", "traceEvents": ev}


# ----------------------------------------------------------- rendering


def _ms(v) -> str:
    return "—" if v is None else f"{v:.1f}"


def render_markdown(asm: dict, att: dict,
                    export_path: str | None, n_events: int,
                    top: int = 5) -> str:
    n_proc = 1 + sum(1 for k in asm["replicas"] if k >= 0)
    lines = [
        f"## Fleet trace — `{asm['base']}`",
        "",
        f"{n_proc} process(es): router "
        f"({len(asm['router_runs'])} life/lives) + "
        f"{sum(1 for k in asm['replicas'] if k >= 0)} replica(s); "
        f"{att['requests']} request(s), {att['completed']} completed",
        "",
    ]
    if export_path:
        lines += [f"Chrome trace: `{export_path}` ({n_events} events — "
                  "open in Perfetto; flow arrows link dispatch→admit, "
                  "failover, resume)", ""]
    if att["rows"]:
        lines += [
            "### Fleet tail attribution",
            "",
            "| metric | n | total | " + " | ".join(FLEET_PHASES)
            + " | other | dominant |",
            "|---|---|---|" + "---|" * (len(FLEET_PHASES) + 2),
        ]
        for row in att["rows"]:
            comps = [_ms(row["components_ms"].get(p))
                     for p in FLEET_PHASES]
            frac = (f" ({100 * row['dominant_frac']:.0f}%)"
                    if row.get("dominant_frac") is not None else "")
            lines.append(
                f"| {row['metric']} p{row['q']} | {row['n']} | "
                f"{_ms(row['value_ms'])} ms | " + " | ".join(comps)
                + f" | {_ms(row['other_ms'])} | "
                  f"**{row['dominant']}**{frac} |")
        lines.append("")
    for msg in tail_incidents(att["rows"]):
        lines.append(f"- **incident**: {msg}")
    worst = sorted((r for r in asm["requests"]
                    if r["e2e_s"] is not None),
                   key=lambda r: -r["e2e_s"])[:top]
    if worst:
        lines += ["", f"### Worst {len(worst)} journey(s) by e2e", ""]
        for w in worst:
            c = w["components_s"]
            hot = ", ".join(f"{p} {_ms(v * 1e3)}"
                            for p, v in c.items() if v > 0)
            lines.append(
                f"- `{w['id']}` [{w['status']}] e2e "
                f"{_ms(w['e2e_s'] * 1e3)} ms — {w['n_dispatches']} "
                f"dispatch(es), {w['n_failovers']} failover(s), "
                f"{w['n_resumes']} resume(s)" + (f": {hot}" if hot
                                                 else ""))
    if asm["evidence_gaps"]:
        lines += ["", "### Evidence gaps", ""]
        lines += [f"- {g}" for g in asm["evidence_gaps"]]
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------- CLI


def run_cli(args) -> int:
    """`obs trace --fleet` entry — `args` is obs/timeline.py's parsed
    namespace (target/--run/--export/--top/--json ride through)."""
    base = Path(args.target)
    if base.is_file():
        base = base.parent
    asm = assemble(base, run=args.run)
    if asm is None:
        print(f"no router telemetry at {base}/telemetry.jsonl — "
              "--fleet wants the router base dir", file=sys.stderr)
        return 2
    if not asm["requests"] and not asm["evidence_gaps"]:
        print(f"no dispatch journeys on {base}/telemetry.jsonl",
              file=sys.stderr)
        return 2
    export_path = None
    trace = None
    if args.export != "none":
        export_path = Path(args.export) if args.export \
            else base / "fleet_trace.json"
        trace = chrome_fleet_trace(asm)
        export_path.parent.mkdir(parents=True, exist_ok=True)
        export_path.write_text(json.dumps(trace, separators=(",", ":")))
    att = attribution(asm)
    if args.json:
        slim = {k: v for k, v in asm.items()
                if not k.startswith("_") and k != "requests"}
        slim["requests"] = [
            {k: v for k, v in r.items()
             if k not in ("edges", "final_leg")}
            for r in asm["requests"]]
        print(json.dumps({
            "fleet": slim, "attribution": att,
            "incidents": tail_incidents(att["rows"]),
            "export": str(export_path) if export_path else None,
        }, indent=2, default=str))
    else:
        print(render_markdown(
            asm, att, str(export_path) if export_path else None,
            len(trace["traceEvents"]) if trace else 0,
            top=args.top), end="")
    return 0
