"""The scaling report and sweep of the port (`metrics/scaling_report.py`,
`bench/scaling.py`) and the `all` job's exit codes, on the CPU.

The report must write the reference's `scaling_analysis.csv` byte for
byte for the same run CSVs (the warmup third dropped, speedup and
efficiency against the one-device run, absolute times only without
one, files that are not runs ignored), and a header-only CSV for an
empty directory. The sweep runs the cifar job at worlds 1 and 2 as
`torchrun` gloo subprocesses with `--device cpu` (2 steps, batch 4, no
validation) under `simulated_cpu/` and reports both. The CLI's sweep
runs on the visible cards unless `--simulate-cpu` or `--device cpu`
asks for gloo ranks, and exits 2 naming `--simulate-cpu` without one.
"""

from __future__ import annotations

import csv
import types
from pathlib import Path

import pytest

from hyperion_tpu.metrics.scaling_report import \
    create_scaling_report as jax_report
from hyperion_tpu_torch.bench import scaling
from hyperion_tpu_torch.cli import main as cli
from hyperion_tpu_torch.metrics.scaling_report import create_scaling_report

HEADER = "epoch,loss,duration_s,gpus\n"


def _run_csv(d: Path, name: str, durations: list[float]) -> None:
    rows = "".join(f"{i + 1},2.0,{t:.6f},1\n"
                   for i, t in enumerate(durations))
    (d / f"{name}_metrics.csv").write_text(HEADER + rows)


def _fixture(d: Path) -> None:
    d.mkdir(parents=True)
    _run_csv(d, "language_ddp_1gpus_20261017_120000", [9.0, 4.0, 4.2])
    _run_csv(d, "language_ddp_2gpus_20261017_120100", [8.0, 2.5, 2.3])
    _run_csv(d, "language_ddp_4gpus_20261017_120200", [7.0, 1.4])
    _run_csv(d, "language_ddp_1gpus_20261017_130000", [5.0, 4.4, 4.6])
    _run_csv(d, "cifar_ddp_2gpus_20261017_120300", [3.0, 1.0, 1.1])
    _run_csv(d, "cifar_ddp_4gpus_20261017_120400", [2.0])
    (d / "cifar_ddp_8gpus_20261017_120500_metrics.csv").write_text(HEADER)
    (d / "notes_metrics.csv").write_text(HEADER + "1,1,1,1\n")


def test_report_csv_is_the_reference_s(tmp_path):
    _fixture(tmp_path / "runs")
    rows = create_scaling_report(tmp_path / "runs", tmp_path / "port")
    jax_report(tmp_path / "runs", tmp_path / "jax")
    got = (tmp_path / "port" / "scaling_analysis.csv").read_bytes()
    assert got == (tmp_path / "jax" / "scaling_analysis.csv").read_bytes()
    assert [(r["model"], r["gpus"]) for r in rows] == [
        ("cifar_ddp", 2), ("cifar_ddp", 4), ("language_ddp", 1),
        ("language_ddp", 2), ("language_ddp", 4)]
    assert rows[2]["speedup"] == 1.0 and rows[0]["speedup"] == ""


def test_empty_directory_makes_up_nothing(tmp_path, capsys):
    (tmp_path / "runs").mkdir()
    assert create_scaling_report(tmp_path / "runs") == []
    jax_report(tmp_path / "runs", tmp_path / "jax")
    got = (tmp_path / "runs" / "scaling_analysis.csv").read_bytes()
    assert got == (tmp_path / "jax" / "scaling_analysis.csv").read_bytes()
    assert got.decode().strip() == \
        "model,gpus,epoch_time_s,speedup,efficiency_pct"
    assert "no *_metrics.csv runs" in capsys.readouterr().out
    assert not (tmp_path / "runs" / "scaling_analysis.png").exists()


@pytest.fixture
def no_settle(monkeypatch):
    """The sweep's 2 s pause between runs, skipped."""
    monkeypatch.setattr(scaling.time, "sleep", lambda s: None)


def test_simulated_sweep_at_worlds_1_and_2(tmp_path, no_settle):
    """The cifar job at worlds 1 and 2 on gloo ranks: a run CSV each,
    and the report's row for each count."""
    rows = scaling.run_scaling_experiment(
        device_counts=[1, 2], models="cifar", epochs=1,
        base_dir=str(tmp_path), steps_per_epoch=2, simulate_on_cpu=True,
        batch_size=4, validate=False)
    assert [(r["model"], r["gpus"]) for r in rows] == [
        ("cifar_ddp", 1), ("cifar_ddp", 2)]
    assert rows[0]["speedup"] == 1.0
    runs = sorted((tmp_path / "simulated_cpu" / "distributed")
                  .glob("cifar_ddp_*_metrics.csv"))
    assert len(runs) == 2
    for path in runs:
        with open(path) as f:
            (row,) = list(csv.DictReader(f))
        assert float(row["loss"]) > 0 and row["gpus"] in ("1", "2")


def test_a_failed_count_does_not_stop_the_sweep(tmp_path, monkeypatch,
                                                no_settle):
    calls = []

    def fake_run(cmd, check):
        calls.append(cmd)
        if "2" == cmd[cmd.index("--nproc-per-node") + 1]:
            raise scaling.subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(scaling.subprocess, "run", fake_run)
    scaling.run_scaling_experiment(
        device_counts=[1, 2, 4], models=["cifar", "llama"],
        base_dir=str(tmp_path), simulate_on_cpu=True)
    assert len(calls) == 6
    llama = calls[-1]
    assert llama[llama.index("--model") + 1] == "llama"
    assert llama[llama.index("--llama_size") + 1] == "tiny"
    assert "--lora" in llama
    assert llama[-2:] == ["--device", "cpu"]  # simulated: gloo ranks


@pytest.mark.parametrize("results, rc", [
    ([False, False, False, False], 0),
    ([False, True, False, False], 75),
    ([True, "health_abort", False, False], 4),
    (["health_abort", True, False, False], 4)])
def test_all_runs_the_four_jobs_and_merges_exit_codes(results, rc,
                                                      monkeypatch, tmp_path):
    """`--model all` runs language_ddp, cifar, language_fsdp and llama
    in turn; a health abort outranks a preemption of any job. The
    primary writes the scaling report at the end."""
    ran = []

    def run_job(args, job):
        ran.append(job)
        return types.SimpleNamespace(preempted=results[len(ran) - 1])

    monkeypatch.setattr(cli, "run_job", run_job)
    assert cli.main(["train", "--model", "all", "--device", "cpu",
                     "--base_dir", str(tmp_path)]) == rc
    assert ran == ["language_ddp", "cifar", "language_fsdp", "llama"]
    assert (tmp_path / "distributed" / "scaling_analysis.csv").exists()


def test_devices_must_match_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--model", "cifar", "--devices", "2"])
    assert exc.value.code == 2


@pytest.fixture
def sweep_calls(monkeypatch, no_settle):
    """The sweep's torchrun commands, recorded and not run."""
    calls = []
    monkeypatch.setattr(scaling.subprocess, "run",
                        lambda cmd, check: calls.append(cmd))
    return calls


def _flag(cmd: list[str], name: str) -> str:
    return cmd[cmd.index(name) + 1]


def test_cli_sweep_without_a_card_names_simulate_cpu(tmp_path, monkeypatch,
                                                     sweep_calls, capsys):
    """No card and neither `--simulate-cpu` nor `--device cpu`: a usage
    error that names the flag, and no run on the CPU."""
    monkeypatch.setattr(scaling, "_cards", lambda: 0)
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--model", "scaling", "--base_dir",
                  str(tmp_path)])
    assert exc.value.code == 2
    assert "--simulate-cpu" in capsys.readouterr().err
    assert sweep_calls == []


def test_cli_sweep_on_one_card_runs_the_counts_that_fit(tmp_path, monkeypatch,
                                                        sweep_calls, capsys):
    """One card at the default `--device cuda`: count 1 runs on the
    card (no `--device cpu`, the report under base_dir), count 2 is
    dropped and said so."""
    monkeypatch.setattr(scaling, "_cards", lambda: 1)
    assert cli.main(["train", "--model", "scaling", "--scaling_devices", "1",
                     "2", "--scaling_jobs", "cifar", "--base_dir",
                     str(tmp_path)]) == 0
    (cmd,) = sweep_calls
    assert _flag(cmd, "--nproc-per-node") == "1" and "--device" not in cmd
    assert _flag(cmd, "--base_dir") == str(tmp_path)
    assert _flag(cmd, "--data_dir") == str(tmp_path)
    assert "running counts [1] of [1, 2]" in capsys.readouterr().out
    assert (tmp_path / "distributed" / "scaling_analysis.csv").exists()


@pytest.mark.parametrize("flags", [["--simulate-cpu"], ["--device", "cpu"]])
def test_cli_sweep_simulates_when_asked(flags, tmp_path, monkeypatch,
                                        sweep_calls):
    """`--simulate-cpu` or `--device cpu` runs every count on gloo ranks,
    a card visible or not, under `simulated_cpu/` (its own CSVs and
    report), reading the corpora from the data directory."""
    monkeypatch.setattr(scaling, "_cards", lambda: 1)
    assert cli.main(["train", "--model", "scaling", "--scaling_devices", "1",
                     "2", "--scaling_jobs", "cifar", "--base_dir",
                     str(tmp_path), "--data_dir", str(tmp_path / "d"),
                     *flags]) == 0
    assert [_flag(c, "--nproc-per-node") for c in sweep_calls] == ["1", "2"]
    for cmd in sweep_calls:
        assert cmd[-2:] == ["--device", "cpu"]
        assert _flag(cmd, "--base_dir") == str(tmp_path / "simulated_cpu")
        assert _flag(cmd, "--data_dir") == str(tmp_path / "d")
    assert (tmp_path / "simulated_cpu" / "distributed" /
            "scaling_analysis.csv").exists()
    assert not (tmp_path / "distributed").exists()
