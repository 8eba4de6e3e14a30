"""The port's trainer launcher (`hyperion_tpu_torch/cli/main.py`) and its
supervisor (`train/supervisor.py`): the reference's trainer flags that
apply on one card, with the reference's defaults; `python -m
hyperion_tpu_torch.cli.main train --device cpu ...` exiting 0, 75 and 4
where the reference's launcher does; `--supervise` over a chaos kill
restarting once and ending bit-identical to an uninterrupted run, its
supervising process never loading torch; the cifar, `all` and
`scaling` jobs; and the `obs` and `simulate` verbs exiting as the
reference's do.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from hyperion_tpu.cli.main import build_parser as jax_build_parser
from hyperion_tpu.train import supervisor as jax_supervisor
from hyperion_tpu_torch import supervisor as port_supervisor
from hyperion_tpu_torch.cli.main import build_parser, main

REPO = Path(__file__).resolve().parents[1]
# the reference's flags that apply on one card
SHARED = ("model", "epochs", "base_dir", "data_dir", "batch_size", "lora",
          "export_merged", "llama_size", "steps_per_epoch", "seq_len",
          "precision", "seed", "dry_init", "no_validate", "no_telemetry",
          "heartbeat_every", "health_policy", "profile_dir",
          "prefetch_depth", "no_async_checkpoint", "chaos", "supervise",
          "max_restarts", "lr", "lr_schedule", "warmup_steps", "grad_accum",
          "remat", "compile_tier", "attention_impl", "train_split",
          "devices", "scaling_devices", "scaling_jobs", "simulate_cpu")
ARGV = ["--model", "llama", "--epochs", "5", "--base_dir", "out",
        "--data_dir", "data", "--batch_size", "4", "--lora",
        "--export-merged", "--llama_size", "tiny", "--steps-per-epoch", "7",
        "--seq_len", "64", "--precision", "fp32", "--seed", "3",
        "--no-validate", "--no-telemetry", "--heartbeat-every", "5",
        "--health-policy", "abort", "--profile-dir", "prof",
        "--prefetch-depth", "0", "--no-async-checkpoint", "--chaos",
        "kill@step=3", "--supervise", "--max-restarts", "4", "--lr", "0.1",
        "--lr-schedule", "warmup_cosine", "--warmup-steps", "2",
        "--grad_accum", "2", "--remat", "dots", "--compile-tier",
        "jit+pallas", "--attention-impl", "pallas", "--train-split", "test",
        "--devices", "2", "--scaling_devices", "1", "2", "--scaling_jobs",
        "cifar", "--simulate-cpu"]
# a llama_tiny full fine-tune cut to seconds (and small checkpoints)
# on the CPU; the trainers share the loop and its exits
SMALL = ["--model", "llama", "--llama_size", "tiny", "--device", "cpu",
         "--epochs", "2", "--steps-per-epoch", "2", "--batch_size", "4",
         "--seq_len", "16", "--no-validate", "--compile-tier", "jit+pallas"]
EXPORT = Path("checkpoints") / "llama_fsdp_bf16_final.npz"


def test_parser_takes_the_reference_flags_with_its_defaults():
    ours, ref = build_parser(), jax_build_parser()
    d_ours, d_ref = vars(ours.parse_args([])), vars(ref.parse_args([]))
    for dest in SHARED:
        assert d_ours[dest] == d_ref[dest], dest
    a_ours, a_ref = vars(ours.parse_args(ARGV)), vars(ref.parse_args(ARGV))
    for dest in SHARED:
        assert a_ours[dest] == a_ref[dest], dest
    assert d_ours["device"] == "cuda"


def test_make_config_matches_the_reference_for_the_ported_jobs():
    from hyperion_tpu.cli.main import make_config as jax_make_config
    from hyperion_tpu_torch.cli.main import make_config

    for job, argv in (("language_ddp", []), ("cifar", []), ("llama", ARGV),
                      ("llama", ["--llama_size", "7b"]),
                      ("language_fsdp", []),
                      ("language_ddp", ["--mesh", "2,1,2,1"])):
        ours = make_config(build_parser().parse_args(argv), job)
        ref = jax_make_config(jax_build_parser().parse_args(argv), job)
        for section in ("train", "optimization", "distributed"):
            got = vars(getattr(ours, section))
            want = vars(getattr(ref, section))
            for k, v in got.items():
                assert v == want[k], (job, section, k)


def test_exit_codes_are_the_references():
    assert (port_supervisor.EXIT_PREEMPTED, port_supervisor.EXIT_HEALTH_ABORT,
            port_supervisor.EXIT_USAGE, port_supervisor.EXIT_GAVE_UP) == \
        (jax_supervisor.EXIT_PREEMPTED, jax_supervisor.EXIT_HEALTH_ABORT,
         jax_supervisor.EXIT_USAGE, jax_supervisor.EXIT_GAVE_UP) == \
        (75, 4, 2, 3)


@pytest.mark.parametrize("job", ["cifar", "all", "scaling"])
def test_deferred_jobs_exit_2_naming_their_item(job, capsys, monkeypatch):
    """The three jobs that exited 2 until they were ported (the name is
    the test's history) now do what the reference's do: cifar's
    `--dry-init` prints its plan (BatchNorm statistics included), `all`
    runs the four jobs in the reference's order, and `--dry-init` with
    the sweep is a usage error."""
    if job == "cifar":
        assert main(["train", "--model", "cifar", "--dry-init",
                     "--mesh", "1,2,1,1"]) == 0
        line = next(x for x in capsys.readouterr().out.splitlines()
                    if "dry-init memory plan" in x)
        assert line.startswith("[cifar_ddp]")
        plan = json.loads(line.split("plan: ", 1)[1])
        assert plan["param_count"] == 11_173_962
        assert "batch_stats_gb" in plan
    elif job == "all":
        from hyperion_tpu_torch.cli import main as cli

        ran = []
        monkeypatch.setattr(cli, "run_job", lambda args, j: ran.append(j)
                            or types.SimpleNamespace(preempted=False))
        assert main(["train", "--model", "all", "--dry-init"]) == 0
        assert ran == ["language_ddp", "cifar", "language_fsdp", "llama"]
    else:
        with pytest.raises(SystemExit) as exc:
            main(["train", "--model", "scaling", "--dry-init"])
        assert exc.value.code == 2
        assert "scaling sweep" in capsys.readouterr().err


@pytest.mark.parametrize("argv, job", [
    (["--model", "language_fsdp", "--mesh", "1,2,1,1"], "language_fsdp"),
    (["--model", "llama", "--llama_size", "7b", "--mesh", "1,4,1,1"],
     "llama")])
def test_dry_init_prints_the_plan_without_a_device(argv, job, capsys):
    """`--dry-init` with explicit axes plans on an abstract mesh: no
    process group and no card (this box has none), exit 0."""
    assert main(["train", "--dry-init", *argv]) == 0
    line = next(x for x in capsys.readouterr().out.splitlines()
                if "dry-init memory plan" in x)
    plan = json.loads(line.split("plan: ", 1)[1])
    assert line.startswith(f"[{job}]")
    assert plan["mesh"]["fsdp"] == int(argv[-1].split(",")[1])
    assert 0 < plan["per_device_gb"] < plan["total_gb"]


@pytest.mark.parametrize("argv, split", [
    (["--mesh", "1,1,1,2"], {"seq": 2}),
    (["--mesh", "1,1,1,1,2,1"], {"pipe": 2}),
    (["--mesh", "1,1,1,1,1,4", "--moe_experts", "4"], {"expert": 4})])
def test_seq_pipe_expert_axes_name_the_next_slice(argv, split, capsys):
    """The seq, pipe and expert axes are ported: a dry-init plans them
    (the stage leaves split over pipe, the experts over expert, so a
    device holds less than the whole) instead of naming a ROADMAP
    item."""
    assert main(["train", "--dry-init", *argv]) == 0
    line = next(x for x in capsys.readouterr().out.splitlines()
                if "dry-init memory plan" in x)
    plan = json.loads(line.split("plan: ", 1)[1])
    assert {k: plan["mesh"][k] for k in split} == split
    if "seq" in split:  # nothing is split over seq
        assert plan["per_device_gb"] == plan["total_gb"]
    else:
        assert 0 < plan["per_device_gb"] < plan["total_gb"]


@pytest.mark.parametrize("verb, item", [("obs", "A6"), ("simulate", "A9")])
def test_deferred_verbs_exit_2_naming_their_item(verb, item, capsys,
                                                 tmp_path):
    """The two verbs that exited 2 until they were ported (the name is
    the test's history; `item` the ROADMAP item that ported them) now
    run through `main` and exit as the reference's do: `obs doctor` on
    the NaN fixture exits 1 (diverged), `simulate failover` at the
    reference tests' small size exits 1 (its fleet-size asserts fail
    on 4 replicas) with the same report."""
    from hyperion_tpu.cli.main import main as jax_main

    if verb == "obs":
        argv = ["obs", "doctor", str(REPO / "tests" / "data" / "telemetry"
                                     / "nan"), "--now", "1754000100"]
    else:
        argv = ["simulate", "failover", "--replicas", "4", "--requests",
                "150", "--duration-s", "90", "--json"]
    got = []
    for name, run in (("port", main), ("jax", jax_main)):
        extra = ["--out", str(tmp_path / name)] if verb == "simulate" else []
        rc = run(argv + extra)
        out = capsys.readouterr().out
        if verb == "simulate":
            res = json.loads(out)
            out = (res["report"], res["asserts"], res["ok"])
        got.append((rc, out))
    assert got[0] == got[1]
    assert got[0][0] == 1


def _cli(base: Path, *extra: str, timeout: float = 180):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("HYPERION_ATTEMPT", None)
    return subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "train",
         *SMALL, "--base_dir", str(base), "--data_dir", str(base / "none"),
         *extra], capture_output=True, text=True, timeout=timeout, env=env,
        cwd=REPO)


def _export(base: Path) -> dict:
    with np.load(base / EXPORT) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("plain")
    yield base, _cli(base)
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Checkpoints add up over a suite: each test's go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_exits_0_on_a_completed_run(plain_run):
    base, r = plain_run
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[llama] epoch 2/2" in r.stdout and _export(base)
    # the reference's report at the end of every run that trains
    assert "[scaling_report]" in r.stdout
    assert (base / "distributed" / "scaling_analysis.csv").exists()


@pytest.mark.parametrize("extra, rc, exported", [
    (["--chaos", "sigterm@step=3"], 75, True),
    (["--chaos", "nan_loss@step=2", "--health-policy", "abort"], 4, False)],
    ids=["preempted", "health_abort"])
def test_cli_exit_codes(tmp_path, extra, rc, exported):
    """The Llama trainer's export rule is the reference's: a preempted
    run still exports (merely early-stopped), an aborted one does not."""
    r = _cli(tmp_path, *extra)
    assert r.returncode == rc, r.stderr[-3000:]
    assert (tmp_path / EXPORT).exists() == exported


def test_supervised_kill_restarts_once_and_ends_bit_identical(plain_run,
                                                              tmp_path):
    """kill@step=3: the child dies after epoch 1's async save was
    written but not committed; the supervisor restarts it once, the
    child adopts that save and retrains epoch 2. The supervising
    process never loads torch."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("HYPERION_ATTEMPT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "train",
         *SMALL, "--base_dir", str(tmp_path), "--data_dir",
         str(tmp_path / "none"), "--supervise", "--max-restarts", "2",
         "--chaos", "kill@step=3"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    maps_read, torch_mapped = 0, False
    deadline = time.monotonic() + 240
    while proc.poll() is None and time.monotonic() < deadline:
        try:
            maps = Path(f"/proc/{proc.pid}/maps").read_text()
            maps_read += 1
            torch_mapped |= "libtorch" in maps
        except OSError:
            pass
        time.sleep(0.2)
    if proc.poll() is None:
        proc.kill()
    out = proc.communicate(timeout=30)[0]
    assert proc.returncode == 0, out[-3000:]
    assert maps_read and not torch_mapped
    assert out.count("[chaos] firing kill@step=3") == 1
    assert "attempt 1:" in out and "attempt 2:" not in out
    assert "adopted step_00000002" in out
    assert "resumed from step 2 (epoch 1)" in out
    want, got = _export(plain_run[0]), _export(tmp_path)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_supervisor_quarantines_on_abort_and_frees_progressing_preemptions(
        tmp_path):
    """Decisions from the exit code and the port's doctor: 4 quarantines
    the newest step dir first; 75 whose stream shows progress (the
    doctor's last_step moved) is a free, immediate restart; a crash
    burns the budget."""
    from hyperion_tpu_torch.obs.trace import Tracer
    from hyperion_tpu_torch.train.supervisor import supervise

    root = tmp_path / "checkpoints" / "language_ddp_1dev"
    codes = iter([75, 4, 1, 0])
    seen: list[tuple[int, list[str]]] = []

    def child(argv, env):
        rc = next(codes)
        step = {75: 3, 4: 6, 1: 6, 0: 6}[rc]
        attempt = int(env["HYPERION_ATTEMPT"])
        tracer = Tracer(tmp_path / "telemetry.jsonl",
                        run=f"language_ddp_1gpus_2026010{attempt}_000000")
        tracer.event("train_start", job="language_ddp", attempt=attempt)
        with tracer.span("train_step", step=step):
            pass
        tracer.close()
        (root / f"step_{step:08d}").mkdir(parents=True, exist_ok=True)
        seen.append((attempt, sorted(p.name for p in root.iterdir())))
        return rc

    sleeps: list[float] = []
    assert supervise(["child"], base_dir=tmp_path, max_restarts=2,
                     run_child=child, sleep=sleeps.append) == 0
    assert [a for a, _ in seen] == [0, 1, 2, 3]
    # exit 4 quarantined step 6, the newest, before the restart (which
    # then wrote a step 6 of its own)
    assert seen[2][1] == ["step_00000003", "step_00000006",
                          "step_00000006.corrupt"]
    assert len(sleeps) == 2  # 75 restarts at once; 4 and 1 back off
