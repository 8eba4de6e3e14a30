"""Restart supervisor for the trainer — `hyperion_tpu/train/supervisor.py`
over the port's restart core (`hyperion_tpu_torch/supervisor.py`).

`python -m hyperion_tpu_torch.cli.main train --supervise --max-restarts
N` reruns the trainer as a subprocess and, on a nonzero exit, asks the
port's `obs doctor` (`obs/doctor.py`) what happened before deciding how
to come back:

    crashed / hung / stalled  -> restart with exponential backoff (the
                                 walk-back resumes from the newest
                                 committed step)
    preempted (exit 75)       -> restart immediately: the mid-epoch
                                 checkpoint is waiting. Free (not counted
                                 against --max-restarts) when the doctor's
                                 `last_step` moved since the last exit
    diverged (exit 4, or the  -> quarantine the diverged job's newest
    doctor says so)              checkpoint (`step_X.corrupt`) first, so
                                 the restart resumes from the PRIOR
                                 verified step instead of re-diverging
    usage error (exit 2)      -> passed through: rejections don't heal
    0                         -> done; 3 = gave up (budget spent)

Each child runs with `HYPERION_ATTEMPT=<k>`, which the trainer stamps
into its `train_start` event and every heartbeat, so the doctor reports
the restart lineage. A consult that fails is logged and the decision
falls back to the exit code: triage is advisory.

The supervising process imports no torch: it spawns, waits, reads the
telemetry stream and heartbeat, and renames directories.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

from hyperion_tpu_torch.supervisor import (  # noqa: F401 — re-exported API
    ATTEMPT_ENV,
    EXIT_GAVE_UP,
    EXIT_HEALTH_ABORT,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_USAGE,
    Decision,
    run_child as _run_child,
    supervise_loop,
)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _consult_doctor(base_dir: str | Path,
                    prefer_diverged: bool = False) -> dict | None:
    """Diagnose the run dir's telemetry; None when there is nothing to
    read (e.g. --no-telemetry) — the caller falls back to exit-code-only
    triage. `prefer_diverged`: a `--model all` child that health-aborts
    on an early job still runs its remaining jobs, so the stream's last
    run (the doctor's default pick) can be a healthy later job — walk
    the runs newest-first for the one that actually diverged, so the
    quarantine hits the right job's checkpoint."""
    try:
        from hyperion_tpu_torch.obs.doctor import diagnose, read_stream

        tele = Path(base_dir) / "telemetry.jsonl"
        if not tele.exists():
            return None
        d = diagnose(base_dir)
        if d.get("verdict") == "empty":
            return None
        if prefer_diverged and d.get("verdict") != "diverged":
            records, _, _ = read_stream(tele)
            run_ids: dict[str, None] = {}
            for r in records:
                if r.get("run"):
                    run_ids.setdefault(r["run"], None)
            for run in reversed(list(run_ids)[:-1]):
                alt = diagnose(base_dir, run=run)
                if alt.get("verdict") == "diverged":
                    return alt
        return d
    except Exception as e:  # noqa: BLE001 — triage is advisory
        print(f"[supervisor] doctor consult failed: {e}", flush=True)
        return None


def _quarantine_newest(base_dir: str | Path, reason: str,
                       run: str | None = None) -> Path | None:
    """Quarantine the newest step dir of the DIVERGED job so the
    restart's walk-back resumes from its prior verified step. `run` is
    the doctor's run id (`{job}_{n}gpus_{ts}`): a `--model all` lineage
    has several job dirs under `<base_dir>/checkpoints/`, and step
    numbers are not comparable across jobs. When the job can't be
    inferred, fall back to the most recently WRITTEN step dir (the
    diverged job is the one that was just training). A step dir holds
    every rank's `shard-<rank>-of-<world>.pt` under one manifest, so
    the rename takes the whole step."""
    from hyperion_tpu_torch.checkpoint import integrity

    job = None
    if run and (m := re.match(r"^(.+)_\d+gpus_\d", str(run))):
        job = m.group(1)
    root = Path(base_dir) / "checkpoints"
    candidates: list[tuple[int, Path]] = []  # (step, path) within a job
    fallback: list[tuple[float, int, Path]] = []
    if root.is_dir():
        for job_dir in root.iterdir():
            if not job_dir.is_dir():
                continue
            for p in job_dir.iterdir():
                if (m := _STEP_RE.match(p.name)) and p.is_dir():
                    if job and job_dir.name.startswith(job):
                        candidates.append((int(m.group(1)), p))
                    fallback.append(
                        (p.stat().st_mtime, int(m.group(1)), p))
    if candidates:
        _, newest = max(candidates)
    elif fallback:
        _, _, newest = max(fallback)
    else:
        return None
    return integrity.quarantine(newest, reason)


def supervise(child_argv: list[str], *, base_dir: str | Path,
              max_restarts: int = 2, backoff_s: float = 1.0,
              max_backoff_s: float = 30.0, run_child=_run_child,
              sleep=time.sleep) -> int:
    """Run `child_argv` under restart supervision. `run_child`/`sleep`
    are injectable for tests."""
    prev_step: list[int | None] = [None]  # closure cell for progress

    def decide(rc: int) -> Decision:
        diag = _consult_doctor(base_dir,
                               prefer_diverged=rc == EXIT_HEALTH_ABORT)
        verdict = diag.get("verdict") if diag else None
        diverged = rc == EXIT_HEALTH_ABORT or verdict == "diverged"
        print(f"[supervisor] child exit {rc}; doctor verdict: "
              f"{verdict or 'unavailable'}"
              + (f" ({diag.get('reason')})" if diag else ""), flush=True)
        # Clean preemptions that made forward progress are free: N
        # capacity events over a long run are normal life, not N
        # failures. Progress is judged from the doctor's last_step, so a
        # child that exits 75 without advancing (a preemption loop, or
        # no telemetry to prove progress) still burns budget.
        cur_step = diag.get("last_step") if diag else None
        progressed = (cur_step is not None
                      and (prev_step[0] is None or cur_step > prev_step[0]))
        prev_step[0] = cur_step if cur_step is not None else prev_step[0]

        if diverged:
            # quarantine even when about to give up: whoever reruns by
            # hand must not resume next to the poisoned state
            q = _quarantine_newest(
                base_dir,
                f"supervisor: diverged (child exit {rc}, verdict "
                f"{verdict or 'n/a'}); restarting from the prior "
                "verified step",
                run=diag.get("run") if diag else None,
            )
            print(f"[supervisor] diverged: quarantined "
                  f"{q.name if q else 'nothing (no checkpoints yet)'}",
                  flush=True)
        # immediate: the capacity event is over; the checkpoint waits
        return Decision.restart(free=rc == EXIT_PREEMPTED and progressed,
                                immediate=rc == EXIT_PREEMPTED)

    return supervise_loop(child_argv, decide=decide,
                          max_restarts=max_restarts, backoff_s=backoff_s,
                          max_backoff_s=max_backoff_s, run_child=run_child,
                          sleep=sleep)
