"""Run-summary reporter: telemetry.jsonl -> dict -> markdown — a copy
of `hyperion_tpu/obs/report.py` over the port's registry, and the `obs`
verb's dispatcher (summarize, doctor, diff, trace, top, profile).

`hyperion obs summarize <telemetry.jsonl>` answers "what did this run do
and how far from roofline was it" from the stream alone — no re-run, no
profiler. The file is append-only across runs, so the reporter groups by
run id and summarizes the latest (or `--run <id>`); `--json` emits the
raw summary dict for tooling.

Summary fields (per run):
    steps / step_time_ms {p50, p90, p99, mean, max}   from train_step spans
    tokens_per_s, samples_per_s, mfu (+ peak source)  last snapshot gauges
    hbm_peak_mb                                       memory high-water
    epochs, total span, slowest spans                 stream-wide
    events                                            count by name
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

# the ONE percentile definition, shared with live snapshots
from hyperion_tpu_torch.obs.registry import percentile as _percentile

_STEP_SPANS = ("train_step", "decode_step", "serve_tick")


def read_records(path: str | Path) -> list[dict]:
    """Parse a telemetry JSONL, skipping unparseable lines (a run killed
    mid-write leaves at most one truncated tail line — the stream must
    stay readable)."""
    records = []
    with Path(path).open(encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def runs(records: list[dict]) -> list[str]:
    """Run ids in first-seen (stream) order."""
    seen: dict[str, None] = {}
    for r in records:
        if r.get("run"):
            seen.setdefault(r["run"], None)
    return list(seen)


def summarize(path: str | Path, run: str | None = None) -> dict:
    """Summary dict for one run of the stream (default: the last one)."""
    records = read_records(path)
    all_runs = runs(records)
    if not all_runs:
        return {"path": str(path), "run": None,
                "error": "no parseable records in stream"}
    if run is not None and run not in all_runs:
        # a filtered-to-empty selection must fail loudly, not render an
        # all-zero report that reads like a real (terrible) run
        return {"path": str(path), "run": run,
                "error": f"run {run!r} not in stream "
                         f"({len(all_runs)} runs; see --list-runs)"}
    run = run or all_runs[-1]
    recs = [r for r in records if r.get("run") == run]

    step_ms = [r["dur_ms"] for r in recs
               if r.get("kind") == "span" and r.get("name") in _STEP_SPANS
               and isinstance(r.get("dur_ms"), (int, float))]
    spans = [r for r in recs if r.get("kind") == "span"]
    snapshots = [r for r in recs if r.get("kind") == "snapshot"]
    events: dict[str, int] = {}
    for r in recs:
        if r.get("kind") == "event":
            events[r.get("name", "?")] = events.get(r.get("name", "?"), 0) + 1

    gauges: dict = {}
    labels: dict = {}
    hbm_peak = None
    for s in snapshots:  # later snapshots win; peak is a high-water max
        m = s.get("metrics", {})
        gauges.update({k: v for k, v in m.get("gauges", {}).items()
                       if v is not None})
        labels.update(m.get("labels", {}))
        p = m.get("gauges", {}).get("hbm_peak_mb")
        if p is not None:
            hbm_peak = p if hbm_peak is None else max(hbm_peak, p)

    slowest = sorted(
        (r for r in spans if isinstance(r.get("dur_ms"), (int, float))),
        key=lambda r: -r["dur_ms"],
    )[:5]
    walls = [r["t_wall"] for r in recs if isinstance(r.get("t_wall"), (int, float))]

    out = {
        "path": str(path),
        "run": run,
        "runs_in_file": len(all_runs),
        "records": len(recs),
        "wall_s": round(max(walls) - min(walls), 3) if walls else None,
        "steps": len(step_ms),
        "step_time_ms": {
            "p50": _percentile(step_ms, 50),
            "p90": _percentile(step_ms, 90),
            "p99": _percentile(step_ms, 99),
            "mean": sum(step_ms) / len(step_ms) if step_ms else float("nan"),
            "max": max(step_ms) if step_ms else float("nan"),
        } if step_ms else None,
        "tokens_per_s": gauges.get("tokens_per_s"),
        "samples_per_s": gauges.get("samples_per_s"),
        "mfu": gauges.get("mfu"),
        "mfu_peak_source": labels.get("mfu_peak_source"),
        "hbm_peak_mb": hbm_peak,
        "epochs": sum(1 for r in spans if r.get("name") == "epoch"),
        "events": events,
        "slowest_spans": [
            {"name": r.get("name"), "path": r.get("path"),
             "step": r.get("step"), "dur_ms": r.get("dur_ms")}
            for r in slowest
        ],
    }
    return out


def _fmt(v, nd: int = 2) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        if math.isnan(v):
            return "—"
        return f"{v:.{nd}f}"
    return str(v)


def render_markdown(s: dict) -> str:
    """The summary as the markdown block a PR/issue/report wants."""
    if s.get("error"):
        return f"## Telemetry summary\n\n`{s['path']}`: {s['error']}\n"
    lines = [
        f"## Telemetry summary — run `{s['run']}`",
        "",
        f"`{s['path']}` · {s['records']} records"
        + (f" · {s['runs_in_file']} runs in file" if s["runs_in_file"] > 1
           else ""),
        "",
        "| metric | value |",
        "|---|---|",
        f"| steps | {s['steps']} |",
    ]
    st = s.get("step_time_ms")
    if st:
        lines += [
            f"| step time p50 | {_fmt(st['p50'])} ms |",
            f"| step time p99 | {_fmt(st['p99'])} ms |",
            f"| step time mean / max | {_fmt(st['mean'])} / "
            f"{_fmt(st['max'])} ms |",
        ]
    if s.get("tokens_per_s") is not None:
        lines.append(f"| tokens/sec | {_fmt(s['tokens_per_s'], 1)} |")
    if s.get("samples_per_s") is not None:
        lines.append(f"| samples/sec | {_fmt(s['samples_per_s'], 1)} |")
    if s.get("mfu") is not None:
        src = s.get("mfu_peak_source") or "?"
        lines.append(f"| MFU | {_fmt(s['mfu'], 4)} (peak: {src}) |")
    lines.append(f"| peak HBM | {_fmt(s['hbm_peak_mb'], 1)} MB |")
    if s.get("epochs"):
        lines.append(f"| epochs | {s['epochs']} |")
    if s.get("wall_s") is not None:
        lines.append(f"| wall time | {_fmt(s['wall_s'])} s |")
    if s.get("events"):
        ev = ", ".join(f"{k}×{v}" for k, v in sorted(s["events"].items()))
        lines += ["", f"**Events:** {ev}"]
    if s.get("slowest_spans"):
        lines += ["", "**Slowest spans:**", ""]
        for sp in s["slowest_spans"]:
            where = f" (step {sp['step']})" if sp.get("step") is not None else ""
            lines.append(
                f"- `{sp.get('path') or sp.get('name')}`{where}: "
                f"{_fmt(sp['dur_ms'])} ms"
            )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # doctor/diff own their full arg surfaces; dispatch before argparse
    # so their --help stays theirs
    if argv and argv[0] == "doctor":
        from hyperion_tpu_torch.obs.doctor import main as doctor_main

        return doctor_main(argv[1:])
    if argv and argv[0] == "diff":
        from hyperion_tpu_torch.obs.diff import main as diff_main

        return diff_main(argv[1:])
    if argv and argv[0] == "trace":
        from hyperion_tpu_torch.obs.timeline import main as trace_main

        return trace_main(argv[1:])
    if argv and argv[0] == "top":
        from hyperion_tpu_torch.obs.top import main as top_main

        return top_main(argv[1:])
    if argv and argv[0] == "profile":
        from hyperion_tpu_torch.obs.export import profile_main

        return profile_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="hyperion obs",
        description="telemetry stream tools (obs/report.py); see also "
                    "`obs doctor <dir>`, `obs diff <a> <b>`, "
                    "`obs trace <dir>`, `obs top <dir>`, and "
                    "`obs profile <dir>`",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("doctor", help="classify a run (healthy/crashed/hung/"
                                  "stalled/diverged) from telemetry + "
                                  "heartbeat")
    sub.add_parser("diff", help="compare two run summaries with a "
                                "regression threshold")
    sub.add_parser("trace", help="per-request waterfalls, Chrome trace "
                                 "export, and tail-latency attribution "
                                 "for a serve run")
    sub.add_parser("top", help="live fleet dashboard over the "
                               "exposition sockets (heartbeat fallback "
                               "for dead processes); --once --json for "
                               "scripting")
    sub.add_parser("profile", help="request an on-demand torch.profiler "
                                   "trace from a live process via its "
                                   "exposition socket")
    s = sub.add_parser("summarize", help="render a run summary from a "
                                         "telemetry JSONL")
    s.add_argument("telemetry", help="path to telemetry.jsonl")
    s.add_argument("--run", default=None,
                   help="run id to summarize (default: last run in file)")
    s.add_argument("--json", action="store_true",
                   help="emit the summary dict as JSON instead of markdown")
    s.add_argument("--list-runs", action="store_true",
                   help="list run ids in the file and exit")
    args = p.parse_args(argv)

    if not Path(args.telemetry).exists():
        print(f"no such file: {args.telemetry}", file=sys.stderr)
        return 2
    if args.list_runs:
        for r in runs(read_records(args.telemetry)):
            print(r)
        return 0
    summary = summarize(args.telemetry, run=args.run)
    if summary.get("error"):
        # empty / filtered-to-empty: one line on stderr, nonzero exit —
        # never a traceback, never an all-zero "report"
        print(f"obs summarize: {args.telemetry}: {summary['error']}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(render_markdown(summary), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
