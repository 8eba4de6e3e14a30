"""Per-request waterfalls, Chrome trace export and tail-latency
attribution for serve runs — the analysis half of
`hyperion_tpu/obs/timeline.py` in the port.

Its `obs trace` CLI (`build_parser`/`main`, which read the records
through `obs/report.py` and `obs/fleet_trace.py`) waits for ROADMAP A6;
the reference's CLI reads the port's telemetry unchanged meanwhile.
`serve/loadgen.py` takes `PHASES` and `cohort_dominant` from here.

A p99 TTFT number says a tail exists; it cannot say WHY. The serve
engine stamps every request's lifecycle onto the telemetry stream
(`request_admitted` → `request_scheduled` → `serve_prefill` span →
`request_first_token` → … → `request_finished` with per-phase totals;
rejects/timeouts carry `queued_s` so they stay visible), and this module
is the consumer that turns those records back into answers:

  * **Waterfalls** — one reconstructed timeline per request (queued /
    block-gated / prefill / decode / preempt-replay segments), exported
    as Chrome trace-event JSON so Perfetto / `chrome://tracing` render
    the run like any other trace: engine ticks on one track, each
    request on its own.
  * **Tail attribution** — TTFT and e2e decomposed at p50/p99 into
    queue / block-gate / prefill / decode / preempt-replay /
    client-write (+ an explicit `other` remainder, so the components
    always sum to the measured latency). Attribution is cohort-based:
    the requests at-or-beyond the quantile are averaged, which keeps
    the decomposition exact instead of summing per-phase percentiles
    that belong to different requests.
  * **Exemplars** — the worst-k requests by e2e with full breakdowns:
    the specific victims to read before believing any aggregate.

Phase definitions (each instant of a request's life lands in exactly
one bucket — see `serve/queue.py:Request`):

    queue_wait     FIFO wait before first slot admission
    gate_wait      tail of that wait spent denied by the block gate
    prefill        the initial prefill call (bucketed suffix compute)
    decode         in-slot tick time between emissions, net of sink time
    preempt_replay pool-exhaustion cost: re-queue wait + re-prefill
    client_write   time inside the transport sink (slow consumers)

Everything here is host-only JSONL parsing — no devices.
"""

from __future__ import annotations

import dataclasses
import math
import re

from hyperion_tpu_torch.obs.registry import percentile

# attribution vocabulary, in waterfall order; `*_s` keys on the
# `request_finished` event map 1:1 onto these names
PHASES = ("queue_wait", "gate_wait", "prefill", "decode",
          "preempt_replay", "client_write")
TTFT_PHASES = ("queue_wait", "gate_wait", "prefill")

_FINISH_KEYS = {
    "queue_wait": "queue_wait_s",
    "gate_wait": "gate_wait_s",
    "prefill": "prefill_s",
    "decode": "decode_s",
    "preempt_replay": "preempt_replay_s",
    "client_write": "client_write_s",
}

_ENGINE_SPANS = ("serve_tick", "serve_prefill", "serve_warmup")


@dataclasses.dataclass
class RequestTrace:
    """One request reconstructed from the stream."""

    id: str
    status: str = "incomplete"   # done|rejected|timed_out|incomplete
    replica: int | None = None   # replica index for router-fleet runs
    prompt_len: int | None = None
    n_tokens: int | None = None
    reason: str | None = None
    preempts: int = 0
    t_submit: float | None = None    # t_mono of request_admitted
    t_finish: float | None = None    # t_mono of the terminal event
    ttft_s: float | None = None
    e2e_s: float | None = None
    queued_s: float | None = None    # rejects/timeouts: time spent queued
    phases: dict = dataclasses.field(default_factory=dict)
    # (name, t0_mono, dur_s) visual segments for the waterfall export
    segments: list = dataclasses.field(default_factory=list)
    # (name, t_mono) instant marks
    marks: list = dataclasses.field(default_factory=list)

    @property
    def other_s(self) -> float | None:
        """Unattributed remainder — scheduling overhead, neighbours'
        prefills inside this request's wall time. Explicit so the
        decomposition sums exactly to e2e."""
        if self.e2e_s is None or not self.phases:
            return None
        return self.e2e_s - sum(self.phases.values())


def _num(v) -> float | None:
    """Finite number or None — json.loads admits bare NaN/Infinity
    literals, and one non-finite stream value must not poison every
    attribution row (percentile over NaN sorts arbitrarily)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if math.isfinite(v) else None


def default_run(records: list[dict]) -> str | None:
    """The run `obs trace` analyzes when none is named: the last run
    (by first appearance on the stream) that carries request events.
    Single definition — the reconstruction, the Chrome export's
    engine-span filter, and the report header must agree on the run
    when two serve processes interleaved one stream."""
    runs_seen: dict[str, None] = {}
    for r in records:
        if r.get("request") and r.get("run"):
            runs_seen.setdefault(r["run"], None)
    return list(runs_seen)[-1] if runs_seen else None


def replica_of_run(run: str | None) -> int | None:
    """Replica index a run id carries (`serve_r<i>_<ts>` — the tag
    `serve/server.py` stamps when spawned by the router), else None."""
    if not run:
        return None
    m = re.match(r"^serve_r(\d+)_", run)
    return int(m.group(1)) if m else None


# the resume-suffix grammar: `serve/server.py:submit_resume` mints
# `{rid}~rN` (N >= 1) wire ids so a resumed recompute never collides
# with the original id on the engine journal. One client request —
# however many resumes — must fold into ONE RequestTrace here, or the
# attribution tables double-count every resumed stream.
_RESUME_SUFFIX = re.compile(r"~r\d+$")


def base_request_id(rid: str) -> str:
    """Strip the resume suffix (`abc~r2` -> `abc`); identity for
    unsuffixed ids. The inverse of `submit_resume`'s minting."""
    return _RESUME_SUFFIX.sub("", rid)


def requests_from_records(records: list[dict],
                          run: str | None = None) -> list[RequestTrace]:
    """Rebuild per-request timelines from one run of a telemetry
    stream (default: `default_run`). Runs produced by a router replica
    carry the replica index in their run id; it is tagged onto every
    RequestTrace so fleet-merged views keep attribution per replica."""
    if run is None:
        run = default_run(records)
    replica = replica_of_run(run)
    recs = sorted(
        (r for r in records
         if r.get("run") == run and r.get("request")
         and isinstance(r.get("t_mono"), (int, float))),
        key=lambda r: r["t_mono"],
    )
    out: dict[str, RequestTrace] = {}
    pending_queue: dict[str, float] = {}   # id -> queue-segment start
    decode_start: dict[str, float] = {}    # id -> decode-segment start
    for r in recs:
        rid = base_request_id(str(r["request"]))
        rt = out.setdefault(rid, RequestTrace(id=rid, replica=replica))
        t = float(r["t_mono"])
        name = r.get("name")
        if r.get("kind") == "span" and name == "serve_prefill":
            dur = (_num(r.get("dur_ms")) or 0.0) / 1e3
            seg = "replay_prefill" if r.get("resumed") else "prefill"
            rt.segments.append((seg, t, dur))
            if rt.prompt_len is None:
                rt.prompt_len = r.get("prompt_len")
            decode_start[rid] = t + dur
            continue
        if r.get("kind") != "event":
            continue
        if name == "request_admitted":
            rt.t_submit = t
            rt.prompt_len = r.get("prompt_len", rt.prompt_len)
            pending_queue[rid] = t
        elif name == "request_scheduled":
            # the queue segment comes from the event's OWN wait payload
            # (start = t - wait): pairing with request_admitted would
            # race it — the admitted event is stamped after the request
            # is already poppable, so its t_mono can land later
            start = pending_queue.pop(rid, None)
            wait = sum(_num(r.get(k)) or 0.0
                       for k in ("queue_wait_s", "gate_wait_s",
                                 "replay_wait_s"))
            seg = "replay_wait" if r.get("resumed") else "queue"
            if wait > 0:
                rt.segments.append((seg, t - wait, wait))
            elif start is not None and t > start:
                # legacy stream without the wait split: fall back to
                # pairing with the enqueue mark
                rt.segments.append((seg, start, t - start))
        elif name == "request_first_token":
            rt.ttft_s = _num(r.get("ttft_s"))
            rt.marks.append(("first_token", t))
        elif name == "request_requeued":
            # popped but bounced before admission (allocation race):
            # close any still-open queue stint, then start the renewed
            # one — no stint may vanish from the waterfall
            start = pending_queue.pop(rid, None)
            if start is not None and t > start:
                rt.segments.append(("queue", start, t - start))
            rt.marks.append(("requeued", t))
            pending_queue[rid] = t
        elif name == "request_preempted":
            rt.preempts += 1
            rt.marks.append(("preempted", t))
            start = decode_start.pop(rid, None)
            if start is not None and t > start:
                rt.segments.append(("decode", start, t - start))
            pending_queue[rid] = t
        elif name == "request_finished":
            rt.status = "done"
            rt.t_finish = t
            rt.reason = r.get("reason")
            rt.n_tokens = r.get("n_tokens")
            rt.preempts = int(r.get("preempts") or rt.preempts)
            rt.e2e_s = _num(r.get("e2e_s"))
            rt.ttft_s = _num(r.get("ttft_s")) or rt.ttft_s
            rt.phases = {
                p: _num(r.get(k)) or 0.0 for p, k in _FINISH_KEYS.items()
            }
            start = decode_start.pop(rid, None)
            if start is not None and t > start:
                rt.segments.append(("decode", start, t - start))
        elif name == "request_rejected":
            rt.status = "rejected"
            rt.t_finish = t
            rt.reason = r.get("reason")
            rt.queued_s = _num(r.get("queued_s")) or 0.0
            rt.t_submit = rt.t_submit if rt.t_submit is not None else t
        elif name == "request_timeout":
            rt.status = "timed_out"
            rt.t_finish = t
            rt.reason = r.get("reason") or "deadline exceeded"
            rt.queued_s = (_num(r.get("queued_s"))
                           if r.get("queued_s") is not None
                           else _num(r.get("waited_s")))
            start = pending_queue.pop(rid, rt.t_submit)
            if start is not None and t > start:
                rt.segments.append(("queue", start, t - start))
    return list(out.values())


# ------------------------------------------------------ Chrome export


def chrome_trace(reqs: list[RequestTrace],
                 records: list[dict] | None = None,
                 run: str | None = None) -> dict:
    """Chrome trace-event JSON (the `{"traceEvents": [...]}` flavour
    Perfetto and chrome://tracing both open): engine spans on tid 0,
    one thread per request, complete ("X") events per phase segment,
    instant ("i") marks for first-token/preemption."""
    t0 = None
    engine_spans: list[dict] = []
    if records is not None:
        for r in records:
            if (r.get("kind") == "span" and r.get("name") in _ENGINE_SPANS
                    and isinstance(r.get("t_mono"), (int, float))
                    and (run is None or r.get("run") == run)):
                engine_spans.append(r)
    for r in reqs:
        for _, t, _d in r.segments:
            t0 = t if t0 is None else min(t0, t)
        if r.t_submit is not None:
            t0 = r.t_submit if t0 is None else min(t0, r.t_submit)
    for s in engine_spans:
        t0 = s["t_mono"] if t0 is None else min(t0, s["t_mono"])
    t0 = t0 or 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    ev: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "hyperion serve"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "engine"}},
    ]
    for s in engine_spans:
        ev.append({
            "name": s["name"], "ph": "X", "pid": 1, "tid": 0,
            "ts": us(s["t_mono"]),
            "dur": round((_num(s.get("dur_ms")) or 0.0) * 1e3, 1),
            "args": {k: s[k] for k in ("step", "active", "request")
                     if k in s},
        })
    for i, r in enumerate(sorted(reqs, key=lambda x: x.t_submit or 0.0)):
        tid = i + 1
        tag = f" r{r.replica}" if r.replica is not None else ""
        ev.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                   "args": {"name": f"req {r.id} [{r.status}]{tag}"}})
        for name, t, dur in r.segments:
            ev.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": us(t), "dur": round(dur * 1e6, 1),
                "args": ({"request": r.id, "replica": r.replica}
                         if r.replica is not None else {"request": r.id}),
            })
        for name, t in r.marks:
            ev.append({"name": name, "ph": "i", "s": "t", "pid": 1,
                       "tid": tid, "ts": us(t),
                       "args": {"request": r.id}})
    return {"displayTimeUnit": "ms", "traceEvents": ev}


# -------------------------------------------------------- attribution


def dominant_of(components: dict, other: float) -> str | None:
    """THE definition of "dominant phase": argmax over the named
    components, demoted to "other" when the unattributed remainder
    outweighs every one of them. Shared by `_cohort_row` and by
    loadgen's bench `dominant_phase_p99`, so the bench serving row and
    `obs trace`/`obs doctor` can never name different culprits for the
    same run."""
    if not components:
        return None
    dom = max(components, key=components.get)
    return "other" if other > components[dom] else dom


def cohort_dominant(values_s: list, phases_s: list,
                    q: int = 99) -> str | None:
    """Dominant phase of the q-th-percentile cohort: select the
    entries whose value is at-or-beyond the percentile, total their
    phases, and apply `dominant_of`. `values_s[i]` and `phases_s[i]`
    (a `{phase: seconds}` dict) describe the same request. This is the
    cohort rule `attribution()` uses, exported so loadgen's bench
    `dominant_phase_p99` runs the identical math on its live requests."""
    if not values_s:
        return None
    cut = percentile(values_s, q)
    idx = [i for i, v in enumerate(values_s) if v >= cut]
    comp: dict[str, float] = {}
    for i in idx:
        for p, v in phases_s[i].items():
            comp[p] = comp.get(p, 0.0) + v
    other = sum(values_s[i] for i in idx) - sum(comp.values())
    return dominant_of(comp, other)


def _cohort_row(metric: str, q: int, cohort: list[RequestTrace],
                phases: tuple[str, ...], value_of) -> dict:
    n = len(cohort)
    value = sum(value_of(r) for r in cohort) / n
    comp = {p: sum(r.phases.get(p, 0.0) for r in cohort) / n
            for p in phases}
    other = value - sum(comp.values())
    dominant = dominant_of(comp, other)
    return {
        "metric": metric, "q": q, "n": n,
        "value_ms": round(value * 1e3, 3),
        "components_ms": {p: round(v * 1e3, 3) for p, v in comp.items()},
        "other_ms": round(other * 1e3, 3),
        "dominant": dominant,
        "dominant_frac": round(
            (comp.get(dominant, other) if dominant != "other" else other)
            / value, 4) if value > 0 else None,
    }


def attribution(reqs: list[RequestTrace],
                quantiles: tuple[int, ...] = (50, 99)) -> dict:
    """Decompose TTFT and e2e tails into phases. Cohort semantics: the
    row for quantile q averages the requests whose metric is at or
    beyond its q-th percentile, so `sum(components) + other == value`
    holds exactly — the property the tier-1 test pins."""
    done = [r for r in reqs if r.status == "done" and r.phases]
    rows: list[dict] = []
    for metric, phases, value_of in (
        ("ttft", TTFT_PHASES,
         lambda r: r.ttft_s),
        ("e2e", PHASES,
         lambda r: r.e2e_s),
    ):
        with_val = [r for r in done if value_of(r) is not None]
        if not with_val:
            continue
        vals = [value_of(r) for r in with_val]
        for q in quantiles:
            cut = percentile(vals, q)
            cohort = [r for r in with_val if value_of(r) >= cut] \
                or [max(with_val, key=value_of)]
            rows.append(_cohort_row(metric, q, cohort, phases, value_of))
    rejected = [r for r in reqs if r.status == "rejected"]
    timed_out = [r for r in reqs if r.status == "timed_out"]

    def _queued(rs):
        qs = [r.queued_s * 1e3 for r in rs if r.queued_s is not None]
        return {"count": len(rs),
                "queued_p50_ms": round(percentile(qs, 50), 3) if qs else None,
                "queued_p99_ms": round(percentile(qs, 99), 3) if qs else None}

    return {
        "requests": len(reqs),
        "completed": len(done),
        "rows": rows,
        # rejects/timeouts stay in the tables — a tail analysis that
        # drops the requests that died waiting is lying about the queue
        "rejected": _queued(rejected),
        "timed_out": _queued(timed_out),
    }


def worst_requests(reqs: list[RequestTrace], k: int = 5) -> list[dict]:
    """The k worst completed requests by e2e, full phase breakdowns —
    plus every timeout (they ARE the tail, however few)."""
    done = sorted((r for r in reqs if r.status == "done"
                   and r.e2e_s is not None),
                  key=lambda r: -r.e2e_s)[:k]
    rows = []
    for r in done:
        rows.append({
            "request": r.id, "status": r.status, "reason": r.reason,
            "e2e_ms": round(r.e2e_s * 1e3, 3),
            "ttft_ms": round(r.ttft_s * 1e3, 3)
            if r.ttft_s is not None else None,
            "n_tokens": r.n_tokens, "preempts": r.preempts,
            "phases_ms": {p: round(r.phases.get(p, 0.0) * 1e3, 3)
                          for p in PHASES},
            "other_ms": round((r.other_s or 0.0) * 1e3, 3),
        })
    for r in reqs:
        if r.status == "timed_out":
            rows.append({
                "request": r.id, "status": r.status, "reason": r.reason,
                "e2e_ms": None, "ttft_ms": None, "n_tokens": 0,
                "preempts": r.preempts,
                "phases_ms": {"queue_wait": round(
                    (r.queued_s or 0.0) * 1e3, 3)},
                "other_ms": 0.0,
            })
    return rows


# ---------------------------------------------------------- rendering


def _ms(v) -> str:
    return "—" if v is None else f"{v:.1f}"


def render_markdown(run: str | None, att: dict, worst: list[dict],
                    export_path: str | None, n_events: int) -> str:
    lines = [
        f"## Request trace — run `{run or '?'}`",
        "",
        f"{att['requests']} request(s): {att['completed']} completed, "
        f"{att['rejected']['count']} rejected, "
        f"{att['timed_out']['count']} timed out",
        "",
    ]
    if export_path:
        lines += [f"Chrome trace: `{export_path}` ({n_events} events — "
                  "open in Perfetto or chrome://tracing)", ""]
    if att["rows"]:
        lines += [
            "### Tail attribution",
            "",
            "| metric | n | total | " + " | ".join(PHASES) + " | other "
            "| dominant |",
            "|---|---|---|" + "---|" * (len(PHASES) + 2),
        ]
        for row in att["rows"]:
            comps = [_ms(row["components_ms"].get(p)) for p in PHASES]
            frac = (f" ({100 * row['dominant_frac']:.0f}%)"
                    if row.get("dominant_frac") is not None else "")
            lines.append(
                f"| {row['metric']} p{row['q']} | {row['n']} | "
                f"{_ms(row['value_ms'])} ms | " + " | ".join(comps)
                + f" | {_ms(row['other_ms'])} | "
                  f"**{row['dominant']}**{frac} |")
        lines.append("")
    for label, key in (("Rejected", "rejected"), ("Timed out", "timed_out")):
        d = att[key]
        if d["count"]:
            lines.append(
                f"{label}: {d['count']} request(s), queued p50/p99 "
                f"{_ms(d['queued_p50_ms'])} / {_ms(d['queued_p99_ms'])} ms")
    if worst:
        n_done = sum(1 for w in worst if w["status"] == "done")
        lines += ["", f"### Worst {n_done} request(s) by e2e", ""]
        for w in worst:
            ph = ", ".join(f"{p} {_ms(v)}"
                           for p, v in w["phases_ms"].items() if v)
            head = (f"- `{w['request']}` [{w['status']}]"
                    + (f" e2e {_ms(w['e2e_ms'])} ms" if w["e2e_ms"] else "")
                    + (f", ttft {_ms(w['ttft_ms'])} ms"
                       if w["ttft_ms"] else ""))
            tail = (f" — {w['n_tokens']} tok"
                    + (f", {w['preempts']} preempt(s)" if w["preempts"]
                       else "")
                    + (f": {ph}" if ph else ""))
            lines.append(head + tail)
    return "\n".join(lines) + "\n"
