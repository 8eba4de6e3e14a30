"""Restart supervisor for the trainer — `hyperion_tpu/train/supervisor.py`
over the port's restart core (`hyperion_tpu_torch/supervisor.py`).

`python -m hyperion_tpu_torch.cli.main train --supervise --max-restarts
N` reruns the trainer as a subprocess and decides from its exit code:

    preempted (exit 75)       -> restart immediately: the mid-epoch
                                 checkpoint is waiting. Free (not counted
                                 against --max-restarts) when the run
                                 progressed: its newest checkpoint step
                                 moved since the last exit
    diverged (exit 4)         -> quarantine the newest checkpoint
                                 (`step_X.corrupt`) first, so the restart
                                 resumes from the PRIOR verified step (or
                                 from scratch) instead of re-diverging
    crashed (any other)       -> restart with exponential backoff (the
                                 walk-back resumes from the newest
                                 committed step)
    usage error (exit 2)      -> passed through: rejections don't heal
    0                         -> done; 3 = gave up (budget spent)

The reference also asks `obs doctor` for a verdict between lives; the
port has no doctor yet (ROADMAP A6), so like the port's serve
supervisor it logs "doctor verdict: unavailable" and decides from the
exit code. Each child runs with `HYPERION_ATTEMPT=<k>`, which the
trainer stamps into its `train_start` event and every heartbeat.

The supervising process imports no torch: it only spawns, waits,
renames directories and reads directory names.
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


def _step_dirs(base_dir: str | Path) -> list[tuple[float, int, Path]]:
    """(mtime, step, path) of every live step dir of every job under
    `<base_dir>/checkpoints/` (quarantined `.corrupt` dirs and `health/`
    evidence don't match)."""
    root = Path(base_dir) / "checkpoints"
    out = []
    if root.is_dir():
        for job_dir in root.iterdir():
            if not job_dir.is_dir():
                continue
            for p in job_dir.iterdir():
                if (m := _STEP_RE.match(p.name)) and p.is_dir():
                    out.append((p.stat().st_mtime, int(m.group(1)), p))
    return out


def newest_step(base_dir: str | Path) -> int | None:
    """The highest checkpoint step on disk — the supervisor's measure of
    a child's progress."""
    return max((step for _, step, _ in _step_dirs(base_dir)), default=None)


def _quarantine_newest(base_dir: str | Path, reason: str) -> Path | None:
    """Quarantine the most recently WRITTEN step dir — the diverged job's,
    the one that was just training — so the restart's walk-back resumes
    from its prior verified step."""
    from hyperion_tpu_torch.checkpoint import integrity

    dirs = _step_dirs(base_dir)
    if not dirs:
        return None
    _, _, newest = max(dirs)
    return integrity.quarantine(newest, reason)


def supervise(child_argv: list[str], *, base_dir: str | Path,
              max_restarts: int = 2, backoff_s: float = 1.0,
              max_backoff_s: float = 30.0, run_child=_run_child,
              sleep=time.sleep) -> int:
    """Run `child_argv` under restart supervision. `run_child`/`sleep`
    are injectable for tests."""
    prev_step: list[int | None] = [newest_step(base_dir)]

    def decide(rc: int) -> Decision:
        print(f"[supervisor] child exit {rc}; doctor verdict: unavailable",
              flush=True)
        cur = newest_step(base_dir)
        progressed = cur is not None and (prev_step[0] is None
                                          or cur > prev_step[0])
        prev_step[0] = cur if cur is not None else prev_step[0]
        if rc == EXIT_HEALTH_ABORT:
            # quarantine even when about to give up: whoever reruns by
            # hand must not resume next to the poisoned state
            q = _quarantine_newest(
                base_dir, f"supervisor: diverged (child exit {rc}); "
                "restarting from the prior verified step")
            print(f"[supervisor] diverged: quarantined "
                  f"{q.name if q else 'nothing (no checkpoints yet)'}",
                  flush=True)
            prev_step[0] = newest_step(base_dir)
        return Decision.restart(free=rc == EXIT_PREEMPTED and progressed,
                                immediate=rc == EXIT_PREEMPTED)

    return supervise_loop(child_argv, decide=decide,
                          max_restarts=max_restarts, backoff_s=backoff_s,
                          max_backoff_s=max_backoff_s, run_child=run_child,
                          sleep=sleep)
