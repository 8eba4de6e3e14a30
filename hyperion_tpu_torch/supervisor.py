"""Shared restart-supervisor core — one crash loop, two policies.

PR 3 built `train/supervisor.py` for the training path: run the child,
on a nonzero exit consult `obs doctor`, decide restart-vs-give-up, back
off exponentially, stamp the attempt lineage. The serve path (PR 8)
needs the identical skeleton with a different policy brain — a serving
child has no "preempted with a checkpoint waiting" exit, but it does
have a request journal to replay and a heartbeat file a hung engine
stops writing. So the loop itself lives here, policy-free:

  * `supervise_loop(child_argv, decide=...)` owns the mechanics every
    supervisor shares: the `HYPERION_ATTEMPT` lineage stamp, the
    exit-0 / usage-error fast paths, the restart budget, exponential
    backoff with deterministic jitter, and the give-up exit code.
  * `decide(rc)` is the policy: given the child's exit code it returns
    a `Decision` — stop with a verdict, or restart (optionally "free",
    not burning the budget; optionally "immediate", skipping backoff).
    Consulting the doctor, quarantining checkpoints, printing triage —
    all policy, all in the caller.
  * `heartbeat_watchdog(...)` wraps a child run with liveness: a child
    whose heartbeat file goes stale past `stale_s` is SIGKILLed and
    reported as hung (negative rc), because a wedged serve loop never
    exits on its own — the doctor's staleness rule, enforced live.

The module is deliberately jax-free (it must stay responsive while a
child holds a dead backend) and import-light: `train/supervisor.py`
and `serve/server.py` both build on it without pulling each other in.

Exit-code contract (shared; `scripts/tpu_watch.sh` branches on it):
    0   the (possibly restarted) run finished
    2   usage error passed through — argparse rejections don't heal
    3   gave up: restart budget exhausted; a human should look
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import subprocess
import time
from pathlib import Path
from typing import Callable

EXIT_OK = 0
EXIT_USAGE = 2
EXIT_GAVE_UP = 3
EXIT_HEALTH_ABORT = 4   # trainer: health policy aborted (diverged)
EXIT_PREEMPTED = 75     # trainer: clean preemption checkpoint, resumable

ATTEMPT_ENV = "HYPERION_ATTEMPT"

# synthetic rc the heartbeat watchdog reports after killing a hung
# child: negative like subprocess's signal convention, distinct from
# -SIGKILL so a policy can tell "we killed it for staleness" from
# "the platform killed it"
RC_HUNG = -1000


@dataclasses.dataclass(frozen=True)
class Decision:
    """One policy verdict for one child exit."""
    action: str                 # "stop" | "restart"
    rc: int = EXIT_GAVE_UP      # returned when action == "stop"
    free: bool = False          # restart without burning the budget
    immediate: bool = False     # restart without backoff

    @classmethod
    def stop(cls, rc: int) -> "Decision":
        return cls("stop", rc=rc)

    @classmethod
    def restart(cls, *, free: bool = False,
                immediate: bool = False) -> "Decision":
        return cls("restart", free=free, immediate=immediate)


def run_child(argv: list[str], env: dict) -> int:
    return subprocess.call(argv, env=env)


def strip_flags(argv: list[str], bare: set[str],
                valued: set[str]) -> list[str]:
    """Child command = supervisor command minus the supervision flags —
    a supervised child must never recursively supervise. `bare` flags
    are removed alone; `valued` flags take one argument (both the
    two-token and `--flag=value` spellings are handled)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in bare:
            pass
        elif a in valued:
            skip = True
        elif any(a.startswith(f + "=") for f in valued):
            pass
        else:
            out.append(a)
    return out


def heartbeat_watchdog(hb_path: str | Path | None, stale_s: float,
                       poll_s: float = 1.0,
                       log: Callable[[str], None] = print,
                       on_spawn: Callable | None = None,
                       popen_kwargs: dict | None = None,
                       ) -> Callable[[list, dict], int]:
    """A `run_child` that SIGKILLs the child when its heartbeat file
    goes stale — the live half of the doctor's hung verdict. Returns
    `RC_HUNG` for a watchdog kill so the policy can name it. With no
    heartbeat path (telemetry off) it degrades to a plain wait: a hung
    child then hangs the supervisor too, which is at least visible.
    `on_spawn(proc)` observes each child Popen (the router uses it to
    keep a signalling handle on every replica); `popen_kwargs` extends
    the spawn (the router redirects replica stdout to stderr so chaos
    chatter never lands on the client wire)."""
    hb_path = Path(hb_path) if hb_path else None

    def _run(argv: list[str], env: dict) -> int:
        start_wall = time.time()
        proc = subprocess.Popen(argv, env=env, **(popen_kwargs or {}))
        if on_spawn is not None:
            on_spawn(proc)
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            if hb_path is not None and stale_s > 0:
                try:
                    mtime = hb_path.stat().st_mtime
                except OSError:
                    mtime = start_wall  # no beat yet
                # clock from THIS child's start or its newest beat,
                # whichever is later: a stale file the previous
                # (crashed) child left must not get a fresh child
                # killed before its first beat — and a child that
                # wedges before ever beating still dies on time
                age = time.time() - max(mtime, start_wall)
                if age > stale_s:
                    log(f"[supervisor] heartbeat stale "
                        f"({age:.0f}s > {stale_s:.0f}s); killing hung "
                        f"child pid {proc.pid}")
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    return RC_HUNG
            time.sleep(poll_s)

    return _run


def supervise_loop(
    child_argv: list[str],
    *,
    decide: Callable[[int], Decision],
    max_restarts: int = 2,
    backoff_s: float = 1.0,
    max_backoff_s: float = 30.0,
    run_child: Callable[[list, dict], int] = run_child,
    sleep=time.sleep,
    label: str = "supervisor",
    log: Callable[[str], None] | None = None,
) -> int:
    """Run `child_argv` under restart supervision with `decide` as the
    policy. `run_child`/`sleep` are injectable for tests; children are
    stamped `HYPERION_ATTEMPT=<k>` so heartbeats and `train_start`/
    `serve_start` events carry the restart lineage `obs doctor`
    reports. `log` redirects the supervisor's own chatter — the serve
    supervisor MUST log to stderr, because its children's stdout IS the
    client's JSONL wire stream."""
    if log is None:
        def log(msg):  # trainer default: stdout, where the tests grep
            print(msg, flush=True)
    rng = random.Random(0)
    restarts = 0
    attempt = 0
    while True:
        env = {**os.environ, ATTEMPT_ENV: str(attempt)}
        log(f"[{label}] attempt {attempt}: {' '.join(child_argv)}")
        rc = run_child(child_argv, env)
        if rc == EXIT_OK:
            if attempt:
                log(f"[{label}] run completed after {attempt} "
                    "restart(s)")
            return EXIT_OK
        if rc == EXIT_USAGE:
            log(f"[{label}] usage error (exit 2); not restarting")
            return rc

        d = decide(rc)
        if d.action == "stop":
            return d.rc
        if not d.free and restarts >= max_restarts:
            log(f"[{label}] giving up after {restarts} restart(s) "
                f"(--max-restarts {max_restarts}); last exit {rc}")
            return EXIT_GAVE_UP
        if not d.free:
            restarts += 1
        attempt += 1
        if d.immediate:
            delay = 0.0
        else:
            delay = min(backoff_s * (2.0 ** (restarts - 1)), max_backoff_s)
            delay *= 1.0 + rng.uniform(-0.25, 0.25)
        if delay:
            log(f"[{label}] restarting in {delay:.1f}s "
                f"(restart {restarts}/{max_restarts})")
            sleep(delay)
