"""Scaling report: speedup and efficiency across device counts —
`hyperion_tpu/metrics/scaling_report.py`, standard library only
(matplotlib, when present, is imported lazily for the PNG).

`create_scaling_report` globs `{job}_{n}gpus_{ts}_metrics.csv`, drops
the first third of each run's epochs as warmup, averages the epoch
durations per job and count, and writes `scaling_analysis.csv` (speedup
= t1 / tn and efficiency = speedup / n against the one-device run) and
`scaling_analysis.png`: the same CSV as the reference's for the same
runs. With no runs it writes a header-only CSV and says so; it makes up
no data.
"""

from __future__ import annotations

import csv
import re
from collections import defaultdict
from pathlib import Path

_RUN = re.compile(r"^(?P<job>.+?)_(?P<n>\d+)gpus_(?P<ts>\d{8}_\d{6})_metrics\.csv$")


def parse_run_name(filename: str) -> tuple[str, int] | None:
    m = _RUN.match(Path(filename).name)
    if not m:
        return None
    return m.group("job"), int(m.group("n"))


def _mean_epoch_duration(path: Path) -> float | None:
    with path.open() as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    durations = [float(r["duration_s"]) for r in rows if "duration_s" in r]
    if not durations:
        return None
    # warmup discard: first third of epochs (reference :656-658) — first
    # epochs carry compilation/cache-warming noise on any backend
    skip = len(durations) // 3
    return sum(durations[skip:]) / len(durations[skip:])


def create_scaling_report(
    metrics_dir: str | Path = "data/distributed",
    out_dir: str | Path | None = None,
) -> list[dict]:
    """Build the speedup/efficiency table; write CSV (+PNG when
    matplotlib is available). Returns the table rows."""
    metrics_dir = Path(metrics_dir)
    out_dir = Path(out_dir) if out_dir else metrics_dir

    per_job: dict[str, dict[int, list[float]]] = defaultdict(lambda: defaultdict(list))
    for f in sorted(metrics_dir.glob("*_metrics.csv")):
        parsed = parse_run_name(f.name)
        if parsed is None:
            continue
        job, n = parsed
        d = _mean_epoch_duration(f)
        if d is not None:
            per_job[job][n].append(d)

    rows: list[dict] = []
    for job, by_n in sorted(per_job.items()):
        means = {n: sum(v) / len(v) for n, v in by_n.items()}
        if 1 not in means:
            # no single-device baseline → report absolute times only
            for n in sorted(means):
                rows.append({
                    "model": job, "gpus": n,
                    "epoch_time_s": round(means[n], 3),
                    "speedup": "", "efficiency_pct": "",
                })
            continue
        t1 = means[1]
        for n in sorted(means):
            speedup = t1 / means[n]
            rows.append({
                "model": job, "gpus": n,
                "epoch_time_s": round(means[n], 3),
                "speedup": round(speedup, 3),
                "efficiency_pct": round(100.0 * speedup / n, 1),
            })

    out_dir.mkdir(parents=True, exist_ok=True)
    out_csv = out_dir / "scaling_analysis.csv"
    with out_csv.open("w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["model", "gpus", "epoch_time_s", "speedup",
                           "efficiency_pct"])
        w.writeheader()
        w.writerows(rows)

    if rows:
        _plot(rows, out_dir / "scaling_analysis.png")
        for r in rows:
            print(f"[scaling_report] {r}")
    else:
        print(f"[scaling_report] no *_metrics.csv runs under {metrics_dir}")
    return rows


def _plot(rows: list[dict], path: Path) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001 — plotting is optional
        return
    jobs = sorted({r["model"] for r in rows})
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for job in jobs:
        sub = [r for r in rows if r["model"] == job and r["speedup"] != ""]
        if not sub:
            continue
        ns = [r["gpus"] for r in sub]
        ax1.plot(ns, [r["speedup"] for r in sub], marker="o", label=job)
        ax2.plot(ns, [r["efficiency_pct"] for r in sub], marker="o", label=job)
    if jobs:
        lim = max((r["gpus"] for r in rows), default=1)
        ax1.plot([1, lim], [1, lim], "k--", alpha=0.4, label="ideal")
    ax1.set_xlabel("devices"); ax1.set_ylabel("speedup"); ax1.legend()
    ax2.set_xlabel("devices"); ax2.set_ylabel("efficiency (%)")
    ax2.axhline(100, color="k", ls="--", alpha=0.4)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
