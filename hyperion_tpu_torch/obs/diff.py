"""`obs diff <a> <b>` — cross-run regression tracking from summaries; a
copy of `hyperion_tpu/obs/diff.py` in the port, with its metric
vocabulary, directions and threshold. It reads and writes nothing but
its inputs and stdout.

Two inputs,
each either a telemetry stream (summarized on the fly via
`obs/report.py`) or an already-written summary JSON (a bench harness
record, a bench.py output line, or a trainer `*_summary.json`), are
normalized onto one metric vocabulary and compared with percent deltas.
A metric that moved in its BAD direction by more than the threshold
(default 10%) is flagged as a regression and the exit code says so —
`obs diff a b || echo regressed` is the whole CI hook.

`--history <glob...>` folds many summaries (e.g. `BENCH_r*.json`) into
one trajectory table instead, so "how has the headline moved across
rounds" is one command, not an archaeology session.

Direction conventions: times and memory regress UP; throughput, MFU,
and vs-baseline regress DOWN.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import math
import sys
from pathlib import Path

# canonical metric vocabulary: name -> direction of GOODNESS
# ("higher" = bigger is better; regression is the other way)
METRICS: dict[str, str] = {
    "step_time_p50_ms": "lower",
    "step_time_p99_ms": "lower",
    "step_time_mean_ms": "lower",
    "tokens_per_s": "higher",
    "samples_per_s": "higher",
    "mfu": "higher",
    "hbm_peak_mb": "lower",
    "headline_tflops": "higher",
    "vs_baseline": "higher",
    "lm_step_ms": "lower",
    "lm_tokens_per_s": "higher",
    # bench.py input_pipeline probe: host batch-assembly rates for the
    # sync vs background-prefetched paths (data/prefetch.py)
    "input_sync_batches_per_s": "higher",
    "input_prefetch_batches_per_s": "higher",
    # bench.py serving probe (serve/loadgen.py against the continuous-
    # batching engine): user-facing SLOs regress UP for latencies and
    # reject rate, DOWN for throughput
    "serve_tokens_per_s": "higher",
    "serve_ttft_p50_ms": "lower",
    "serve_ttft_p99_ms": "lower",
    "serve_reject_rate": "lower",
    # paged-KV-cache pressure (serve/blocks.py): hit rate falling, or
    # blocks/HBM-per-request rising, means lost sharing — the same
    # capacity regression as a throughput drop, gated the same way
    "serve_prefix_hit_rate": "higher",
    "serve_blocks_in_use": "lower",
    "serve_hbm_per_req_mb": "lower",
    # per-phase tail attribution (obs/timeline.py via the bench serving
    # row): gating the COMPONENTS catches a tail that merely moved —
    # e.g. queue wait doubling while prefill halves leaves ttft_p99
    # flat and would sail through the aggregate gate
    "serve_queue_wait_p99_ms": "lower",
    "serve_gate_wait_p99_ms": "lower",
    "serve_prefill_p99_ms": "lower",
    "serve_decode_p99_ms": "lower",
    "serve_preempt_replay_p99_ms": "lower",
    "serve_client_write_p99_ms": "lower",
    # overload brownout (serve/queue.py:BrownoutGovernor via the bench
    # serving row): more shed or clamped requests at the same offered
    # load means lost capacity — gated like any other serving regression
    "serve_shed_rate": "lower",
    "serve_clamp_rate": "lower",
    # SLO burn-rate alerting (obs/slo.py via the bench serving row):
    # alerts raised under the same seeded load is a direct "the SLO
    # got worse" signal — lower is better, zero is the healthy state
    "serve_alerts_raised": "lower",
    # speculative decoding (serve/draft.py via the bench serving row's
    # @spec dimension, k=4 point): acceptance falling means the draft
    # stopped predicting the target, tokens-per-slot-tick falling
    # means the speedup itself regressed — both gated alongside the
    # TTFT keys above so speculation can never buy throughput by
    # selling first-token latency unnoticed
    "serve_accept_rate": "higher",
    "serve_tokens_per_tick": "higher",
    # replica-tier scaling (serve/router.py via the bench serving_scale
    # row): aggregate throughput at N replicas, scaleup vs one replica,
    # dispatch fairness (min replica share x N; 1.0 = perfectly even),
    # and the prefix/session affinity hit rate that keeps each
    # replica's radix cache warm — any of them falling means the
    # router, not an engine, regressed
    "serve_scale_tokens_per_s": "higher",
    "serve_scale_scaleup": "higher",
    "serve_scale_fairness": "higher",
    "serve_affinity_hit_rate": "higher",
    # compile ledger (obs/ledger.py via the bench serving row): post-
    # warmup jit-cache growth. Zero-pinned: the healthy value is
    # EXACTLY 0, so any increase is a regression regardless of the
    # percent threshold (see ZERO_PINNED below)
    "serve_recompiles": "lower",
    # workload isolation (the bench serving row's @class
    # dimension): interactive TTFT p99 under a hostile mixed-class load
    # is THE isolation promise — and batch sheds rising at the same
    # offered load means the batch tier lost ground it used to hold.
    # Both gated so neither tier can quietly pay for the other.
    "serve_interactive_ttft_p99_ms": "lower",
    "serve_batch_shed_rate": "lower",
    # exactly-once delivery (the bench serving_scale row):
    # stream-indexed duplicate deliveries the CLIENTS observed across
    # the fleet run — zero-pinned, one duplicate is a dedup bug
    "serve_duplicate_tokens": "lower",
    # cross-process tracing (the bench serving_scale row):
    # router overhead the CLIENT observes (client TTFT minus the
    # replica-attributed TTFT) and the p99 failover gap (replica death
    # detected -> first record from the replacement). Both are time
    # the fleet spends BETWEEN processes — invisible to every
    # per-process gate above, so they get their own
    "serve_router_overhead_p99_ms": "lower",
    "serve_failover_gap_p99_ms": "lower",
    # fleet flight simulator (serve/simulate.py via the bench fleet_sim
    # probe): pinned herd + failover scenarios replayed at every bench
    # run. These gate POLICY — a dispatch, steering, brownout, or
    # failover change that degrades what the scenario asserts shows up
    # here even when every per-process engine gate above stays flat.
    "sim_herd_shed_rate": "lower",
    "sim_herd_completed_rate": "higher",
    "sim_herd_interactive_ttft_p99_ms": "lower",
    "sim_herd_alerts_raised": "lower",
    "sim_herd_duplicate_tokens": "lower",
    "sim_failover_completed_rate": "higher",
    "sim_failover_interactive_ttft_p99_ms": "lower",
    "sim_failover_gap_p99_ms": "lower",
    "sim_failover_steer_reversals": "lower",
    "sim_failover_duplicate_tokens": "lower",
    # paged decode-attention probe (ops/pallas/paged_attention
    # via the bench decode_attention row): gather and pallas kernel
    # throughput each gated against their OWN history (never against
    # each other — on the host the kernel runs interpreted and loses by
    # design), plus jit-cache growth under block-table churn. Zero-
    # pinned: the block table is runtime data; ONE executable must
    # serve every table/base combination, so any recompile is a
    # retrace bug, not a drift.
    "decode_attn_tokens_per_s": "higher",
    "decode_attn_gather_tokens_per_s": "higher",
    "decode_attn_recompiles": "lower",
    # tiered KV cache (serve/hostcache.py via the bench serving
    # row's @rehit dimension): the host spill tier's whole value is
    # prefill work NOT redone after eviction — its hit rate or restore
    # bandwidth falling, or the prefill tokens the caches saved
    # falling, means evicted prefixes are being recomputed again.
    # `scripts/check_diff_gates.py` cross-checks these against
    # hostcache.TIER_GATED so the promise and the gate can never drift.
    "serve_tier_hit_rate_host": "higher",
    "serve_restore_bytes_per_s": "higher",
    "serve_prefill_tokens_saved": "higher",
}

# metrics whose healthy value is exactly zero: the percent-threshold
# machinery is meaningless at a zero base (0 -> 1 is an infinite
# increase), so any move OFF zero in the bad direction regresses —
# these skip the zero-base bail-out in `diff()` instead of hiding in it
ZERO_PINNED = frozenset({"serve_recompiles",
                         # the class probe's healthy batch shed rate IS
                         # 0.0 — a zero-base skip would hide the exact
                         # regression this gate exists for
                         "serve_batch_shed_rate",
                         # exactly-once delivery: the ONLY healthy
                         # duplicate count is 0
                         "serve_duplicate_tokens",
                         # the simulated fleet makes the same promise —
                         # a duplicate under virtual failover is the
                         # same dedup bug, caught cheaper
                         "sim_herd_duplicate_tokens",
                         "sim_failover_duplicate_tokens",
                         # paged-attention kernel: block tables are
                         # runtime data — a single recompile under
                         # table churn is a retrace bug
                         "decode_attn_recompiles"})


def _num(v) -> float | None:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    v = float(v)
    return v if math.isfinite(v) else None


def normalize(doc: dict) -> dict[str, float]:
    """Map any known summary shape onto the canonical metric names,
    keeping only finite numbers. Unknown shapes yield {} rather than
    guessing."""
    # round wrapper {"cmd": ..., "rc": ..., "parsed": {...}}
    if "parsed" in doc and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    out: dict[str, float] = {}
    st = doc.get("step_time_ms")
    if isinstance(st, dict):  # obs summarize --json
        for k, name in (("p50", "step_time_p50_ms"),
                        ("p99", "step_time_p99_ms"),
                        ("mean", "step_time_mean_ms")):
            v = _num(st.get(k))
            if v is not None:
                out[name] = v
    for k in ("tokens_per_s", "samples_per_s", "mfu", "hbm_peak_mb",
              "vs_baseline"):
        v = _num(doc.get(k))
        if v is not None:
            out[k] = v
    # bench.py headline line {"metric": "matmul_...", "value": ...}
    if "metric" in doc:
        v = _num(doc.get("value"))
        if v is not None:
            out["headline_tflops"] = v
        extra = doc.get("extra")
        if isinstance(extra, dict):
            for k in ("lm_step_ms", "lm_tokens_per_s"):
                v = _num(extra.get(k))
                if v is not None:
                    out[k] = v
        pipe = doc.get("input_pipeline")
        if isinstance(pipe, dict):
            for src, name in (("sync_batches_per_s",
                               "input_sync_batches_per_s"),
                              ("prefetch_batches_per_s",
                               "input_prefetch_batches_per_s")):
                v = _num(pipe.get(src))
                if v is not None:
                    out[name] = v
        srv = doc.get("serving")
        if isinstance(srv, dict):
            for src, name in (("tokens_per_s", "serve_tokens_per_s"),
                              ("ttft_p50_ms", "serve_ttft_p50_ms"),
                              ("ttft_p99_ms", "serve_ttft_p99_ms"),
                              ("reject_rate", "serve_reject_rate"),
                              ("prefix_hit_rate", "serve_prefix_hit_rate"),
                              ("blocks_in_use", "serve_blocks_in_use"),
                              ("hbm_per_req_mb", "serve_hbm_per_req_mb"),
                              ("queue_wait_p99_ms",
                               "serve_queue_wait_p99_ms"),
                              ("gate_wait_p99_ms",
                               "serve_gate_wait_p99_ms"),
                              ("prefill_p99_ms", "serve_prefill_p99_ms"),
                              ("decode_p99_ms", "serve_decode_p99_ms"),
                              ("preempt_replay_p99_ms",
                               "serve_preempt_replay_p99_ms"),
                              ("client_write_p99_ms",
                               "serve_client_write_p99_ms"),
                              ("shed_rate", "serve_shed_rate"),
                              ("clamp_rate", "serve_clamp_rate"),
                              ("alerts_raised", "serve_alerts_raised"),
                              ("accept_rate", "serve_accept_rate"),
                              ("tokens_per_tick",
                               "serve_tokens_per_tick"),
                              ("recompiles", "serve_recompiles"),
                              ("interactive_ttft_p99_ms",
                               "serve_interactive_ttft_p99_ms"),
                              ("batch_shed_rate",
                               "serve_batch_shed_rate"),
                              ("tier_hit_rate_host",
                               "serve_tier_hit_rate_host"),
                              ("restore_bytes_per_s",
                               "serve_restore_bytes_per_s"),
                              ("prefill_tokens_saved",
                               "serve_prefill_tokens_saved")):
                v = _num(srv.get(src))
                if v is not None:
                    out[name] = v
        scale = doc.get("serving_scale")
        if isinstance(scale, dict):
            for src, name in (("tokens_per_s", "serve_scale_tokens_per_s"),
                              ("scaleup", "serve_scale_scaleup"),
                              ("fairness", "serve_scale_fairness"),
                              ("affinity_hit_rate",
                               "serve_affinity_hit_rate"),
                              ("duplicate_tokens",
                               "serve_duplicate_tokens"),
                              ("router_overhead_p99_ms",
                               "serve_router_overhead_p99_ms"),
                              ("failover_gap_p99_ms",
                               "serve_failover_gap_p99_ms")):
                v = _num(scale.get(src))
                if v is not None:
                    out[name] = v
        # bench fleet_sim probe (serve/simulate.py): the child already
        # stamps canonical diff names (sim_<scenario>_<key>), so the
        # branch only has to keep the ones the gate vocabulary knows
        fsim = doc.get("fleet_sim")
        if isinstance(fsim, dict):
            for name in METRICS:
                if not name.startswith("sim_"):
                    continue
                v = _num(fsim.get(name))
                if v is not None:
                    out[name] = v
        # bench decode_attention probe (ops/pallas/paged_attention):
        # like fleet_sim, the child stamps canonical decode_attn_*
        # names directly — keep the ones the gate vocabulary knows
        dattn = doc.get("decode_attention")
        if isinstance(dattn, dict):
            for name in METRICS:
                if not name.startswith("decode_attn_"):
                    continue
                v = _num(dattn.get(name))
                if v is not None:
                    out[name] = v
    # trainer *_summary.json {"step_ms": ..., "peak_hbm_mb": ...}
    if "step_ms" in doc:
        v = _num(doc.get("step_ms"))
        if v is not None:
            out["step_time_mean_ms"] = v
    if "peak_hbm_mb" in doc and "hbm_peak_mb" not in out:
        v = _num(doc.get("peak_hbm_mb"))
        if v is not None:
            out["hbm_peak_mb"] = v
    return out


def load_summary(path: str | Path, run: str | None = None) -> dict:
    """{"label", "metrics", "error"?} for one input — a run dir, a
    telemetry JSONL, or a summary JSON file."""
    from hyperion_tpu_torch.obs import report

    path = Path(path)
    label = path.name if path.name != "telemetry.jsonl" else path.parent.name
    if path.is_dir():
        path = path / "telemetry.jsonl"
        label = Path(label).name
    if not path.exists():
        return {"label": label, "metrics": {}, "error": f"no such file: {path}"}
    if path.suffix == ".jsonl":
        s = report.summarize(path, run=run)
        if s.get("error"):
            return {"label": label, "metrics": {}, "error": s["error"]}
        return {"label": s.get("run") or label, "metrics": normalize(s)}
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return {"label": label, "metrics": {},
                "error": f"unreadable summary: {e}"}
    if not isinstance(doc, dict):
        return {"label": label, "metrics": {},
                "error": "summary is not a JSON object"}
    return {"label": label, "metrics": normalize(doc)}


def diff(a: dict, b: dict, threshold: float = 0.10) -> dict:
    """Compare two normalized summaries; delta_pct is b vs a (positive =
    b larger). A regression is a move in the metric's bad direction
    strictly beyond `threshold`."""
    rows = []
    for name, direction in METRICS.items():
        va, vb = a["metrics"].get(name), b["metrics"].get(name)
        if name in ZERO_PINNED:
            # zero-pinned gate: the healthy value IS 0, so the zero-base
            # skip below would hide exactly the regressions this metric
            # exists to catch. Any move in the bad direction regresses,
            # threshold be damned (0 recompiles -> 1 is a broken
            # invariant, not a 10% drift).
            if va is None or vb is None:
                continue
            worse = vb > va if direction == "lower" else vb < va
            rows.append({
                "metric": name, "a": va, "b": vb,
                "delta_pct": (round(100 * (vb - va) / abs(va), 2)
                              if va else None),
                "better": direction,
                "regression": bool(worse),
            })
            continue
        if va is None or vb is None or va == 0:
            continue  # a zero base has no percent delta (a dead-tunnel
            # 0.0 headline should be triaged by doctor, not diffed)
        delta = (vb - va) / abs(va)
        worse = delta > 0 if direction == "lower" else delta < 0
        rows.append({
            "metric": name, "a": va, "b": vb,
            "delta_pct": round(100 * delta, 2),
            "better": "lower" if direction == "lower" else "higher",
            "regression": bool(worse and abs(delta) > threshold),
        })
    return {
        "a": a["label"], "b": b["label"],
        "threshold_pct": round(100 * threshold, 1),
        "rows": rows,
        "regressions": [r["metric"] for r in rows if r["regression"]],
        "comparable_metrics": len(rows),
    }


def render_markdown(d: dict) -> str:
    lines = [
        f"## Run diff — `{d['a']}` → `{d['b']}`",
        "",
        f"regression threshold: {d['threshold_pct']}% "
        "(in each metric's bad direction)",
        "",
    ]
    if not d["rows"]:
        lines.append("no comparable metrics between the two summaries")
        return "\n".join(lines) + "\n"
    lines += ["| metric | a | b | Δ% | verdict |", "|---|---|---|---|---|"]
    for r in d["rows"]:
        dp = "—" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}%"
        verdict = "**REGRESSED**" if r["regression"] else "ok"
        lines.append(f"| {r['metric']} ({r['better']}=better) | "
                     f"{r['a']:.4g} | {r['b']:.4g} | {dp} | {verdict} |")
    if d["regressions"]:
        lines += ["", f"**{len(d['regressions'])} regression(s):** "
                  + ", ".join(d["regressions"])]
    else:
        lines += ["", "no regressions beyond threshold"]
    return "\n".join(lines) + "\n"


def history(paths: list[str | Path]) -> dict:
    """Fold many summaries into one trajectory: rows in name order (the
    naming convention `BENCH_r01 … BENCH_r05` IS the time axis)."""
    entries = []
    for p in sorted(paths, key=lambda x: str(x)):
        s = load_summary(p)
        entries.append(s)
    cols = [m for m in METRICS
            if any(m in e["metrics"] for e in entries)]
    return {"entries": entries, "columns": cols}


def render_history(h: dict) -> str:
    cols = h["columns"]
    if not h["entries"]:
        return "no summaries matched\n"
    lines = ["## Run history", "",
             "| summary | " + " | ".join(cols) + " |",
             "|---|" + "---|" * len(cols)]
    for e in h["entries"]:
        cells = []
        for c in cols:
            v = e["metrics"].get(c)
            cells.append("—" if v is None else f"{v:.4g}")
        note = " (unreadable)" if e.get("error") else ""
        lines.append(f"| {e['label']}{note} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="hyperion obs diff",
        description="compare two run summaries (telemetry JSONL or "
                    "summary JSON) with a regression threshold, or fold "
                    "a set of summaries into a trajectory table",
    )
    p.add_argument("inputs", nargs="*",
                   help="two inputs to diff (run dir, telemetry.jsonl, "
                        "or summary .json)")
    p.add_argument("--threshold", type=float, default=0.10,
                   help="regression threshold as a fraction (0.10 = 10%%)")
    p.add_argument("--run-a", default=None,
                   help="run id inside input A when it is a stream")
    p.add_argument("--run-b", default=None,
                   help="run id inside input B when it is a stream")
    p.add_argument("--history", nargs="+", default=None, metavar="GLOB",
                   help="trajectory mode: summarize each file matching "
                        "the glob(s) (e.g. 'BENCH_r*.json') into one table")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    if args.history:
        paths: list[str] = []
        for g in args.history:
            hits = sorted(_glob.glob(g))
            paths.extend(hits if hits else ([g] if Path(g).exists() else []))
        if not paths:
            print(f"--history matched no files: {args.history}",
                  file=sys.stderr)
            return 2
        h = history(paths)
        print(json.dumps(h, indent=2, default=str) if args.json
              else render_history(h), end="" if not args.json else "\n")
        return 0

    if len(args.inputs) != 2:
        p.error("need exactly two inputs (or --history)")
    a = load_summary(args.inputs[0], run=args.run_a)
    b = load_summary(args.inputs[1], run=args.run_b)
    for s in (a, b):
        if s.get("error"):
            print(f"{s['label']}: {s['error']}", file=sys.stderr)
            return 2
    d = diff(a, b, threshold=args.threshold)
    print(json.dumps(d, indent=2) if args.json else render_markdown(d),
          end="" if not args.json else "\n")
    if not d["rows"]:
        print("nothing comparable between the two inputs", file=sys.stderr)
        return 2
    return 1 if d["regressions"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
