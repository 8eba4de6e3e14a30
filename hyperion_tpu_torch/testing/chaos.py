"""Deterministic fault injection — the harness that finally *exercises*
the fault-tolerance machinery instead of trusting it.

Nothing in the tree ever killed a trainer mid-epoch, corrupted a
checkpoint, or made storage flake on purpose; `PreemptionGuard`,
`HealthMonitor`, verified-checkpoint walk-back, and the restart
supervisor were all reaction paths tested only by the faults nobody
injected. A chaos plan is a comma-separated fault spec, from `--chaos`
or `HYPERION_CHAOS`:

    kill@step=N          SIGKILL the process before training step N
                         (the preemption platform's no-grace kill)
    sigterm@step=N       SIGTERM before step N (graceful preemption —
                         drives PreemptionGuard end-to-end)
    nan_loss@step=N      poison the HealthMonitor's loss scalar at step
                         N (divergence without waiting for real NaNs)
    stall@step=N:SECS    sleep SECS before step N (stall/hang shapes)
    kill@tick=N          the same kill/sigterm/stall family scoped to
    sigterm@tick=N       the SERVE loop's decode ticks (serve/engine.py
    stall@tick=N:SECS    calls `on_tick` before tick N) — a stalled
                         engine stops beating, which is exactly what
                         `obs doctor` must flag as hung
    slow_client@tick=N:SECS
                         sleep SECS inside the engine's token-delivery
                         path at tick N — a consumer that stops
                         draining (dead socket, wedged pipe) and
                         backpressures the serve loop from the client
                         side rather than the device side
    slowloris@tenant=NAME:SECS
                         adversarial tenant: EVERY token delivered to a
                         request tagged `tenant=NAME` sleeps SECS — a
                         client that reads one byte at a time forever.
                         Standing (exempt from the fire-once record):
                         the attack is sustained drain starvation, and
                         the defense under test is workload isolation —
                         co-running tenants' TTFT/TPOT must hold while
                         `obs doctor` names the offender
    crash@tick=N         hard `os._exit` before serve tick N — no
                         signal handlers, no atexit, no flushes beyond
                         what already hit the kernel: the ugliest
                         process death the journal replay must survive
    crash@dispatch=N     the same hard `os._exit`, scoped to the ROUTER:
                         fires after the router has journaled its Nth
                         dispatch — mid-stream router death with live
                         replicas behind it, the exact shape the router
                         WAL + `--supervise` failover must survive
    conn_reset@p=X       probabilistic client-wire reset: each token
                         about to cross a client connection flips a
                         seeded coin and, on X, hard-resets that
                         connection (RST, not FIN) — the flaky network
                         the client's stream-resume path exists for.
                         Standing (exempt from the fire-once record):
                         every connection is at risk for the whole run
    journal_io_fail@p=X  raise OSError with probability X inside the
                         request journal's append path
                         (serve/journal.py) — durability must degrade,
                         never kill the serve loop
    poison_request@id=ID SIGKILL the process every time request ID is
                         about to occupy a slot — the adversarial
                         request the poison-pill replay rule exists
                         for (fires EVERY time, exempt from the
                         once-per-lineage record: re-crashing on replay
                         is the point)
    corrupt_ckpt@latest  at activation, corrupt the newest existing
                         checkpoint (truncate its largest payload file)
                         — the partial-save artifact restore must skip
    io_fail@p=X          raise OSError with probability X at every
                         `utils.retry.fault_point` (checkpoint IO,
                         dataset reads, the batch iterator) — what the
                         retry/backoff layer exists for

Determinism contract: step-targeted faults fire **exactly once per run
lineage**, not once per process — a supervisor-restarted trainer passes
through the same global step again and must not re-die there (the fire
record persists to a JSON state file next to the run's outputs, written
*before* the fault executes, because a SIGKILL never returns).
`io_fail` draws from a seeded RNG, so a given (plan, seed) flakes at
the same call sequence every time.

Hook sites: the trainer's step loop (`on_step`, `poison_loss`),
checkpoint save/restore + dataset reads (via `utils.retry.fault_point`),
and activation (`corrupt_ckpt`). Production modules never import this
one; the trainer activates a plan only when one is configured.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import time
from pathlib import Path

import numpy as np

from hyperion_tpu_torch.utils import retry as retry_mod

ENV_VAR = "HYPERION_CHAOS"

_STEP_CLAUSE = re.compile(r"^(kill|sigterm|nan_loss|stall)@step=(\d+)(?::([0-9.]+))?$")
_TICK_CLAUSE = re.compile(
    r"^(kill|sigterm|stall|slow_client|crash)@tick=(\d+)(?::([0-9.]+))?$")
_CKPT_CLAUSE = re.compile(r"^corrupt_ckpt@latest$")
_IO_CLAUSE = re.compile(r"^io_fail@p=([0-9.]+)$")
_JOURNAL_CLAUSE = re.compile(r"^journal_io_fail@p=([0-9.]+)$")
_POISON_CLAUSE = re.compile(r"^poison_request@id=([\w.:-]+)$")
_TENANT_CLAUSE = re.compile(r"^slowloris@tenant=([\w.:-]+):([0-9.]+)$")
_DISPATCH_CLAUSE = re.compile(r"^crash@dispatch=(\d+)$")
_CONNRESET_CLAUSE = re.compile(r"^conn_reset@p=([0-9.]+)$")


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str                 # kill | sigterm | nan_loss | stall | slow_client | slowloris | crash | corrupt_ckpt | io_fail | journal_io_fail | conn_reset | poison_request
    step: int | None = None   # trainer step, serve tick, or router dispatch
    secs: float = 0.0         # stall / slow_client / slowloris duration
    p: float = 0.0            # io_fail / journal_io_fail / conn_reset probability
    unit: str = "step"        # "step" (trainer) | "tick" (serve) | "dispatch" (router)
    rid: str | None = None    # poison_request id OR slowloris tenant

    @property
    def key(self) -> str:
        """Canonical id for the one-shot fire record."""
        if self.kind in ("stall", "slow_client"):
            return f"{self.kind}@{self.unit}={self.step}:{self.secs}"
        if self.kind in ("io_fail", "journal_io_fail", "conn_reset"):
            return f"{self.kind}@p={self.p}"
        if self.kind == "corrupt_ckpt":
            return "corrupt_ckpt@latest"
        if self.kind == "poison_request":
            return f"poison_request@id={self.rid}"
        if self.kind == "slowloris":
            return f"slowloris@tenant={self.rid}:{self.secs}"
        return f"{self.kind}@{self.unit}={self.step}"


def parse_plan(spec: str) -> list[Fault]:
    """Parse a fault spec; raises ValueError naming the bad clause."""
    faults: list[Fault] = []
    for raw in spec.replace(";", ",").split(","):
        clause = raw.strip()
        if not clause:
            continue
        if m := _STEP_CLAUSE.match(clause):
            kind, step, secs = m.group(1), int(m.group(2)), m.group(3)
            if kind == "stall" and secs is None:
                raise ValueError(
                    f"chaos clause {clause!r}: stall wants stall@step=N:SECS")
            faults.append(Fault(kind, step=step,
                                secs=float(secs) if secs else 0.0))
        elif m := _TICK_CLAUSE.match(clause):
            kind, tick, secs = m.group(1), int(m.group(2)), m.group(3)
            if kind in ("stall", "slow_client") and secs is None:
                raise ValueError(
                    f"chaos clause {clause!r}: {kind} wants "
                    f"{kind}@tick=N:SECS")
            faults.append(Fault(kind, step=tick, unit="tick",
                                secs=float(secs) if secs else 0.0))
        elif _CKPT_CLAUSE.match(clause):
            faults.append(Fault("corrupt_ckpt"))
        elif m := _IO_CLAUSE.match(clause):
            p = float(m.group(1))
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos clause {clause!r}: p outside [0,1]")
            faults.append(Fault("io_fail", p=p))
        elif m := _JOURNAL_CLAUSE.match(clause):
            p = float(m.group(1))
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos clause {clause!r}: p outside [0,1]")
            faults.append(Fault("journal_io_fail", p=p))
        elif m := _POISON_CLAUSE.match(clause):
            faults.append(Fault("poison_request", rid=m.group(1)))
        elif m := _TENANT_CLAUSE.match(clause):
            faults.append(Fault("slowloris", rid=m.group(1),
                                secs=float(m.group(2))))
        elif m := _DISPATCH_CLAUSE.match(clause):
            faults.append(Fault("crash", step=int(m.group(1)),
                                unit="dispatch"))
        elif m := _CONNRESET_CLAUSE.match(clause):
            p = float(m.group(1))
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos clause {clause!r}: p outside [0,1]")
            faults.append(Fault("conn_reset", p=p))
        else:
            raise ValueError(
                f"unknown chaos clause {clause!r} (grammar: kill@step=N, "
                "sigterm@step=N, nan_loss@step=N, stall@step=N:SECS, "
                "kill@tick=N, sigterm@tick=N, stall@tick=N:SECS, "
                "slow_client@tick=N:SECS, slowloris@tenant=NAME:SECS, "
                "crash@tick=N, crash@dispatch=N, journal_io_fail@p=X, "
                "conn_reset@p=X, poison_request@id=ID, "
                "corrupt_ckpt@latest, io_fail@p=X)")
    return faults


class ChaosPlan:
    """A parsed plan plus its persistent fire record.

    `state_path=None` keeps the record in-memory (fires once per
    process); a path makes it once per *lineage* — the supervisor's
    restarted children share it and skip already-fired faults."""

    def __init__(self, faults: list[Fault], state_path: str | Path | None = None,
                 seed: int = 0):
        self.faults = list(faults)
        self.state_path = Path(state_path) if state_path else None
        self._rng = np.random.default_rng(seed)
        self._jrng = np.random.default_rng(seed + 1)  # journal_io_fail
        self._crng = np.random.default_rng(seed + 2)  # conn_reset
        self._fired: set[str] = set()
        self._announced: set[str] = set()  # standing faults log once
        if self.state_path is not None and self.state_path.exists():
            try:
                self._fired = set(
                    json.loads(self.state_path.read_text()).get("fired", []))
            except (OSError, json.JSONDecodeError, ValueError):
                pass  # a torn state file must not crash the run

    # ------------------------------------------------------ fire record

    def _mark(self, fault: Fault) -> bool:
        """Record a fault as fired BEFORE executing it (a SIGKILL never
        returns to write afterwards). False = already fired, skip."""
        if fault.key in self._fired:
            return False
        self._fired.add(fault.key)
        if self.state_path is not None:
            try:
                self.state_path.parent.mkdir(parents=True, exist_ok=True)
                tmp = self.state_path.with_name(self.state_path.name + ".tmp")
                tmp.write_text(json.dumps({"fired": sorted(self._fired)}))
                os.replace(tmp, self.state_path)
            except OSError:
                pass  # chaos bookkeeping must not out-crash the chaos
        return True

    # ------------------------------------------------------------ hooks

    def on_step(self, step: int) -> None:
        """Trainer step-loop hook, called with the global step about to
        train. kill/sigterm/stall fire here; nan_loss fires in
        `poison_loss` (it needs the loss value path, not the process)."""
        for f in self.faults:
            if f.unit != "step" or f.step != step \
                    or f.kind not in ("kill", "sigterm", "stall"):
                continue
            if not self._mark(f):
                continue
            print(f"[chaos] firing {f.key}", flush=True)
            if f.kind == "kill":
                # Let an in-flight ASYNC checkpoint write finish before
                # the no-grace kill, so "kill@step=N" is step-exact and
                # deterministic: steps 0..N-1 completed and the last
                # epoch-boundary save is on disk. Its commit point (the
                # manifest) does not run, as after any kill: the
                # walk-back adopts the save by its commit marker. (The
                # reference's hook commits the save instead.)
                try:
                    from hyperion_tpu_torch.checkpoint import io as ckpt_io

                    ckpt_io.join_pending()
                except Exception:  # noqa: BLE001 — chaos must still fire
                    pass
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "stall":
                time.sleep(f.secs)

    def on_tick(self, tick: int) -> None:
        """Serve-loop hook (serve/engine.py calls this before decode
        tick N): the kill/sigterm/stall family scoped to serving. A
        stall here freezes the engine's host loop — heartbeats stop,
        which is the exact signature `obs doctor` classifies as hung."""
        for f in self.faults:
            if f.unit != "tick" or f.step != tick \
                    or f.kind not in ("kill", "sigterm", "stall", "crash"):
                continue
            if not self._mark(f):
                continue
            print(f"[chaos] firing {f.key}", flush=True)
            if f.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "crash":
                # os._exit: no handlers, no atexit, no tracer flush —
                # only bytes already written to the kernel survive,
                # which is exactly the durability bar the request
                # journal claims to meet
                os._exit(70)
            elif f.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "stall":
                time.sleep(f.secs)

    def on_client(self, tick: int, req=None) -> None:
        """Token-delivery-path faults. slow_client@tick=N:SECS — the
        consumer side wedges once (dead socket, blocked pipe) while the
        device side is healthy, backpressuring the serve loop from the
        client edge. slowloris@tenant=NAME:SECS — a STANDING delay on
        every token delivered to `req`s tagged with that tenant (the
        adversarial client that reads one byte at a time), announced
        once but exempt from the fire record: sustained starvation is
        the attack, isolation of everyone else is the test."""
        for f in self.faults:
            if f.kind == "slow_client" and f.unit == "tick" \
                    and f.step == tick and self._mark(f):
                print(f"[chaos] firing {f.key}", flush=True)
                time.sleep(f.secs)
            elif f.kind == "slowloris" and req is not None \
                    and getattr(req, "tenant", None) == f.rid:
                if f.key not in self._announced:
                    self._announced.add(f.key)
                    print(f"[chaos] firing {f.key} (standing)", flush=True)
                time.sleep(f.secs)

    def on_dispatch(self, n: int) -> None:
        """crash@dispatch=N — the router's hook, called with its
        monotonic dispatch count right after the Nth dispatch record
        hit the WAL. Same `os._exit` semantics as crash@tick: only
        bytes already in the kernel survive, which is exactly what the
        dispatch/hwm fsync ordering claims is enough to recover from.
        Fires once per lineage so the supervisor-restarted router can
        pass the same count again without re-dying."""
        for f in self.faults:
            if f.kind == "crash" and f.unit == "dispatch" \
                    and f.step == n and self._mark(f):
                print(f"[chaos] firing {f.key}", flush=True)
                os._exit(70)

    def conn_reset(self, tag: str) -> None:
        """conn_reset@p=X — the client-wire injector: each call (one
        per token about to cross a client connection) flips a seeded
        coin (its own RNG stream, so adding a reset plan never shifts
        the io_fail/journal_io sequences) and raises
        ConnectionResetError on X. The caller owns turning the raise
        into a real RST on its socket."""
        for f in self.faults:
            if f.kind == "conn_reset" and f.p > 0.0 \
                    and self._crng.random() < f.p:
                raise ConnectionResetError(
                    f"[chaos] injected conn_reset at {tag!r}")

    def on_request(self, request_id: str) -> None:
        """poison_request@id=ID — fired by the serve engine when the
        request is about to occupy a slot. Deliberately EXEMPT from the
        fire record: the poison pill is defined by crashing again on
        every replay, and the defense under test is the journal's
        replay counter, not the chaos bookkeeping."""
        for f in self.faults:
            if f.kind == "poison_request" and f.rid == request_id:
                print(f"[chaos] firing {f.key}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

    def journal_io(self, tag: str) -> None:
        """journal_io_fail@p=X — the request journal's append-path
        injector (its own seeded RNG, so adding a journal plan never
        shifts the io_fail@p sequence checkpoint tests pinned)."""
        for f in self.faults:
            if f.kind == "journal_io_fail" and f.p > 0.0 \
                    and self._jrng.random() < f.p:
                raise OSError(f"[chaos] injected journal_io_fail at {tag!r}")

    def poison_loss(self, step: int, loss: float) -> float:
        """nan_loss@step=N: the value the HealthMonitor sees at step N
        becomes NaN — divergence on demand, no numerics lottery."""
        for f in self.faults:
            if f.kind == "nan_loss" and f.step == step and self._mark(f):
                print(f"[chaos] firing {f.key}", flush=True)
                return float("nan")
        return loss

    def poison_epoch(self, start_step: int, end_step: int,
                     loss: float) -> float:
        """Lazy-backend arm of nan_loss: per-step scalars never reach
        the host there, so the HealthMonitor judges the fetched epoch
        MEAN — poison it when the epoch's step range covered the target
        (same one-epoch-late granularity the monitor itself has on
        those backends)."""
        for f in self.faults:
            if f.kind == "nan_loss" and f.step is not None \
                    and start_step <= f.step < end_step and self._mark(f):
                print(f"[chaos] firing {f.key} (epoch granularity)",
                      flush=True)
                return float("nan")
        return loss

    def io_fail(self, tag: str) -> None:
        """`utils.retry.fault_point` injector: seeded coin-flip OSError."""
        for f in self.faults:
            if f.kind == "io_fail" and f.p > 0.0 \
                    and self._rng.random() < f.p:
                raise OSError(f"[chaos] injected io_fail at {tag!r}")

    def corrupt_latest_checkpoint(self, root: str | Path) -> Path | None:
        """corrupt_ckpt@latest, executed at activation: truncate the
        largest payload file of the newest `step_*` dir under any job
        dir below `root` — the exact artifact a mid-save crash leaves,
        except the manifest still *claims* the full size, so
        verification must catch it."""
        fault = next((f for f in self.faults if f.kind == "corrupt_ckpt"), None)
        if fault is None:
            return None
        step_re = re.compile(r"^step_(\d+)$")
        candidates: list[tuple[int, Path]] = []
        root = Path(root)
        if root.is_dir():
            for job_dir in root.iterdir():
                if not job_dir.is_dir():
                    continue
                for p in job_dir.iterdir():
                    if (m := step_re.match(p.name)) and p.is_dir():
                        candidates.append((int(m.group(1)), p))
        if not candidates or not self._mark(fault):
            return None
        _, target = max(candidates, key=lambda c: (c[0], c[1].stat().st_mtime))
        payload = max(
            (p for p in target.rglob("*")
             if p.is_file() and p.name != "manifest.json"),
            key=lambda p: p.stat().st_size,
            default=None,
        )
        if payload is None:
            return None
        size = payload.stat().st_size
        with payload.open("r+b") as f:
            f.truncate(size // 2)
        print(f"[chaos] firing corrupt_ckpt@latest: truncated "
              f"{payload.relative_to(target)} in {target} "
              f"({size} -> {size // 2} bytes)", flush=True)
        return target


# --------------------------------------------------- ambient activation

_current: ChaosPlan | None = None
# state files already lineage-reset by THIS process: a `--model all`
# run calls activate() once per job, and only the first may clear the
# fire record — otherwise each job would re-arm already-fired faults,
# breaking the exactly-once-per-lineage contract
_reset_done: set[str] = set()


def current() -> ChaosPlan | None:
    return _current


def activate(spec: str | None, *, state_path: str | Path | None = None,
             seed: int = 0, checkpoint_root: str | Path | None = None
             ) -> ChaosPlan | None:
    """Install the process-wide plan (empty/None spec falls back to
    `HYPERION_CHAOS`, then deactivates). Registers the io_fail injector
    with `utils.retry` and executes any activation-time faults
    (corrupt_ckpt). Trainers call this once per run."""
    global _current
    spec = spec or os.environ.get(ENV_VAR, "")
    if not spec:
        _current = None
        retry_mod.set_fault_injector(None)
        return None
    # Lineage boundary: the fire record exists so a supervisor-restarted
    # child (HYPERION_ATTEMPT >= 1) doesn't re-die at an already-fired
    # step. A fresh attempt-0 PROCESS is a NEW lineage — without this
    # reset, re-running the same drill in the same base_dir would
    # silently inject nothing and read as "recovery exercised". Reset
    # at most once per process: later activate() calls in the same
    # process (`--model all` runs one per job) stay in the lineage.
    if state_path is not None \
            and str(state_path) not in _reset_done \
            and not int(os.environ.get("HYPERION_ATTEMPT", "0") or 0):
        _reset_done.add(str(state_path))
        try:
            Path(state_path).unlink(missing_ok=True)
        except OSError:
            pass
    plan = ChaosPlan(parse_plan(spec), state_path=state_path, seed=seed)
    _current = plan
    retry_mod.set_fault_injector(
        plan.io_fail if any(f.kind == "io_fail" for f in plan.faults) else None
    )
    if checkpoint_root is not None:
        plan.corrupt_latest_checkpoint(checkpoint_root)
    return plan
