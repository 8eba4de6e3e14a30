"""The port's supervisors consult the port's `obs doctor` and decide as
the reference's do. The train supervisor (`train/supervisor.py`) runs
injected children (the reference's own tests do the same,
tests/test_supervisor.py) beside the JAX package's supervisor on twin
directories: a child that writes a NaN stream and exits 1 is
quarantined; a `--model all` lineage quarantines the job that diverged,
not the newest; a preemption whose doctor `last_step` did not move
burns budget, one that moved is free; with no stream the verdict is
"unavailable" and the exit code decides; a consult that raises is
logged and the restart goes on. Each case holds the port's exit code,
attempts, backoff sleeps, log and checkpoint tree to the reference's.
The serve and route supervisors log the doctor's verdict between lives
as the reference's do.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import pytest

from hyperion_tpu.train import supervisor as jsup
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.train import supervisor as psup

NAN = float("nan")


def _run_id(job: str, attempt: int, k: int = 0) -> str:
    return f"{job}_1gpus_2026010{attempt}_00000{k}"


def _write_job(base: Path, job: str, attempt: int, *, steps: range,
               k: int = 0, diverge: bool = False, end: bool = True,
               preempted: bool = False, ckpt_every: int = 4) -> None:
    """One trainer run's records and step dirs, as the trainers lay
    them out: `<base>/telemetry.jsonl` (appended) and
    `<base>/checkpoints/<job>_1dev/step_<n>/`."""
    t = Tracer(base / "telemetry.jsonl", run=_run_id(job, attempt, k), proc=0)
    t.event("train_start", job=job, attempt=attempt)
    for s in steps:
        with t.span("train_step", step=s):
            pass
        if s and s % ckpt_every == 0:
            d = base / "checkpoints" / f"{job}_1dev" / f"step_{s:08d}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "shard-00000-of-00001.pt").write_bytes(b"x")
    if diverge:
        t.event("health", step=steps[-1], anomaly="nonfinite_loss",
                fatal=True, value=NAN, action="abort")
        t.event("health_abort", epoch=1, steps_done=len(steps))
    if end:
        t.event("train_end", preempted="signal" if preempted else False)
    t.close()


class Script:
    """An injected `run_child`: attempt k runs `plays[k](base, k)` and
    returns its exit code."""

    def __init__(self, base: Path, plays):
        self.base, self.plays, self.attempts = base, list(plays), []

    def __call__(self, argv, env):
        k = int(env[psup.ATTEMPT_ENV])
        self.attempts.append(k)
        return self.plays.pop(0)(self.base, k)


def _tree(base: Path) -> list[str]:
    root = base / "checkpoints"
    return sorted(str(p.relative_to(root)) for p in root.glob("*/*")) \
        if root.is_dir() else []


def _decide_both(tmp_path, capsys, plays, **kw) -> dict:
    out = {}
    for name, mod in (("port", psup), ("jax", jsup)):
        base = tmp_path / name
        base.mkdir()
        child, sleeps = Script(base, plays), []
        rc = mod.supervise(["child"], base_dir=base, run_child=child,
                           sleep=sleeps.append, **kw)
        out[name] = {"rc": rc, "attempts": child.attempts,
                     "sleeps": len(sleeps), "tree": _tree(base),
                     "log": capsys.readouterr().out}
    assert out["port"] == out["jax"]
    return out["port"]


def test_nan_stream_with_a_plain_crash_is_quarantined(tmp_path, capsys):
    """The child's loss went NaN and it died with exit 1, not 4: the
    doctor's `diverged` quarantines the newest step all the same."""
    def nan_then_crash(base, k):
        _write_job(base, "language_ddp", k, steps=range(1, 10),
                   diverge=True, end=False)
        return 1

    def resume(base, k):
        _write_job(base, "language_ddp", k, steps=range(5, 13))
        return 0

    got = _decide_both(tmp_path, capsys, [nan_then_crash, resume],
                       max_restarts=1)
    assert got["rc"] == 0 and got["attempts"] == [0, 1]
    assert "child exit 1; doctor verdict: diverged (1 fatal health " \
        "event(s) (nonfinite_loss); run aborted by health policy)" \
        in got["log"]
    assert "diverged: quarantined step_00000008" in got["log"]
    assert "language_ddp_1dev/step_00000008.corrupt" in got["tree"]


def test_model_all_quarantines_the_diverged_job(tmp_path, capsys):
    """`--model all`: cifar diverged, language_fsdp then trained on and
    wrote the newest, highest step; exit 4 quarantines cifar's newest
    step, found by walking the runs for the diverged one."""
    def lineage(base, k):
        _write_job(base, "language_ddp", k, steps=range(1, 9), k=0)
        _write_job(base, "cifar_ddp", k, steps=range(1, 10), k=1,
                   diverge=True)
        _write_job(base, "language_fsdp", k, steps=range(1, 17), k=2)
        return 4

    def done(base, k):
        return 0

    got = _decide_both(tmp_path, capsys, [lineage, done], max_restarts=1)
    assert got["rc"] == 0
    assert "child exit 4; doctor verdict: diverged" in got["log"]
    assert "cifar_ddp_1dev/step_00000008.corrupt" in got["tree"]
    assert "language_fsdp_1dev/step_00000016" in got["tree"]
    assert "language_ddp_1dev/step_00000008" in got["tree"]


@pytest.mark.parametrize("steps, rc, attempts", [
    ([10, 10, 10], 3, [0, 1, 2]),          # no progress: budget burns
    ([10, 20, 30, None], 0, [0, 1, 2, 3])])  # progress: free restarts
def test_preemptions_are_free_only_with_doctor_progress(
        tmp_path, capsys, steps, rc, attempts):
    def play(last):
        def child(base, k):
            if last is None:
                return 0
            _write_job(base, "language_ddp", k,
                       steps=range(last - 3, last + 1), preempted=True)
            return psup.EXIT_PREEMPTED
        return child

    got = _decide_both(tmp_path, capsys, [play(s) for s in steps],
                       max_restarts=1 if rc == 3 else 0)
    assert (got["rc"], got["attempts"], got["sleeps"]) == (rc, attempts, 0)
    assert got["log"].count("doctor verdict: healthy") == len(
        [s for s in steps if s is not None])


def test_no_stream_means_exit_code_triage(tmp_path, capsys):
    """--no-telemetry: no verdict; exit 4 still quarantines (the most
    recently written step) and a preemption without evidence of
    progress burns budget."""
    def abort(base, k):
        for s in (4, 8):
            d = base / "checkpoints" / "language_ddp_1dev" / f"step_{s:08d}"
            d.mkdir(parents=True)
        return 4

    def preempt(base, k):
        return psup.EXIT_PREEMPTED

    got = _decide_both(tmp_path, capsys, [abort, preempt, preempt],
                       max_restarts=2)
    assert got["rc"] == psup.EXIT_GAVE_UP and got["attempts"] == [0, 1, 2]
    assert got["log"].count("doctor verdict: unavailable") == 3
    assert "language_ddp_1dev/step_00000008.corrupt" in got["tree"]


def test_a_failed_consult_is_advisory(tmp_path, capsys, monkeypatch):
    from hyperion_tpu.obs import doctor as jdoctor
    from hyperion_tpu_torch.obs import doctor as pdoctor

    def broken(*a, **k):
        raise ValueError("torn stream")

    monkeypatch.setattr(pdoctor, "diagnose", broken)
    monkeypatch.setattr(jdoctor, "diagnose", broken)

    def crash(base, k):
        _write_job(base, "language_ddp", k, steps=range(1, 5), end=False)
        return 1

    got = _decide_both(tmp_path, capsys, [crash, lambda b, k: 0],
                       max_restarts=1)
    assert got["rc"] == 0 and got["sleeps"] == 1
    assert "[supervisor] doctor consult failed: torn stream" in got["log"]
    assert "doctor verdict: unavailable" in got["log"]


# ----------------------------------------------------- serve and route


def _log_of(supervise, runner_mod, argv, args, monkeypatch, capsys,
            plays) -> str:
    calls = iter(plays)
    monkeypatch.setattr(runner_mod, "run_child",
                        lambda child_argv, env: next(calls)())
    assert supervise(argv, args) == 0
    return capsys.readouterr().err


def test_serve_supervisor_logs_the_verdict(tmp_path, capsys, monkeypatch):
    import hyperion_tpu.serve.server as jserver
    import hyperion_tpu.supervisor as jcore
    import hyperion_tpu_torch.serve.server as pserver
    import hyperion_tpu_torch.supervisor as pcore

    logs = {}
    for name, server, core in (("port", pserver, pcore),
                               ("jax", jserver, jcore)):
        tele = tmp_path / name / "telemetry.jsonl"
        tele.parent.mkdir()
        monkeypatch.setenv("HYPERION_TELEMETRY", str(tele))

        def crashed(tele=tele):
            t = Tracer(tele, run="serve_1", proc=0)
            with t.span("serve_tick", step=1):
                pass
            t.close()
            with tele.open("a") as f:
                f.write('{"v": 1, "kind": "ev')  # killed mid-record
            return 70

        args = argparse.Namespace(hang_timeout=0.0, max_restarts=1,
                                  journal=str(tmp_path / name / "j.jsonl"))
        logs[name] = _log_of(server.supervise_serve, core, ["--slots", "2"],
                             args, monkeypatch, capsys,
                             [crashed, lambda: 0])
    line = ("[serve-supervisor] child exit 70; doctor verdict: crashed; "
            "restarting with journal replay")
    assert line in logs["port"] and line in logs["jax"]


def test_route_supervisor_logs_the_verdict(tmp_path, capsys, monkeypatch):
    import hyperion_tpu.serve.router as jrouter
    import hyperion_tpu.supervisor as jcore
    import hyperion_tpu_torch.serve.router as prouter
    import hyperion_tpu_torch.supervisor as pcore

    lines = {}
    for name, router, core in (("port", prouter, pcore),
                               ("jax", jrouter, jcore)):
        base = tmp_path / name

        def life(base=base):
            t = Tracer(base / "telemetry.jsonl", run="route_1", proc=0)
            t.event("router_start", replicas=2)
            t.close()
            return 1

        args = argparse.Namespace(hang_timeout=0.0, max_restarts=1,
                                  base_dir=str(base))
        log = _log_of(router.supervise_route, core, ["--replicas", "2"],
                      args, monkeypatch, capsys, [life, lambda: 0])
        lines[name] = [x for x in log.splitlines() if "doctor verdict" in x]
    assert lines["port"] == lines["jax"] == [
        "[route-supervisor] router exit 1; doctor verdict: running; "
        "restarting — the new life re-adopts live replicas and recovers "
        "the dispatch WAL"]
