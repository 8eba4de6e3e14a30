"""The scaling sweep — `hyperion_tpu/bench/scaling.py`
(`run_scaling_experiment`).

Each job runs at each device count in a fresh subprocess, and the
scaling report (`metrics/scaling_report.py`) is written over their CSVs
at the end. In the reference a device count is a mesh size inside one
process (`--devices N`); in the port it is a world size: each run is
`torchrun --standalone --nproc-per-node N -m hyperion_tpu_torch.cli.main
train --model JOB --devices N ...`, one rank a card. On the cards
(`simulate_on_cpu=False`) the counts are cut to the visible cards, and
with none left the sweep raises. Simulated (`simulate_on_cpu=True`) it
runs gloo ranks on the CPU (`--device cpu`, counts up to 8: the
collectives and the data sharding are real, the times are the host's)
under `{base_dir}/simulated_cpu`, so its CSVs and its report never mix
with card runs in `base_dir`. `None` is the reference's rule: simulate
when fewer than two cards are visible, and say so. One failed count
does not stop the sweep, as in the reference.

    python -m hyperion_tpu_torch.cli.main train --model scaling \\
        [--simulate-cpu | --device cpu] [--scaling_devices 1 2] \\
        [--scaling_jobs cifar]
"""

from __future__ import annotations

import subprocess
import sys
import time

from hyperion_tpu_torch.metrics.scaling_report import create_scaling_report


def _default_counts(limit: int) -> list[int]:
    counts = [n for n in (1, 2, 4, 8) if n <= limit]
    return counts or [1]


# the reference's four jobs; llama scales in its LoRA form at the tiny
# size, so a simulated sweep can run it
SCALING_JOBS = ("language_ddp", "cifar", "language_fsdp", "llama")
_JOB_EXTRA_FLAGS = {"llama": ("--llama_size", "tiny", "--lora")}


def _cards() -> int:
    import torch

    return torch.cuda.device_count()


def run_scaling_experiment(
    device_counts: list[int] | None = None,
    models: str | list[str] = SCALING_JOBS,
    epochs: int = 3,
    base_dir: str = "data",
    steps_per_epoch: int = 20,
    simulate_on_cpu: bool | None = None,
    batch_size: int | None = None,
    validate: bool = True,
    data_dir: str = "",
) -> list[dict]:
    """Run each job at each device count in a fresh subprocess; return
    the report's rows. The jobs read their corpora from `data_dir`
    (default `base_dir`), also when simulated."""
    data_dir = data_dir or base_dir
    if simulate_on_cpu is None:
        simulate_on_cpu = _cards() < 2
        if simulate_on_cpu:
            print("[scaling] fewer than two cards visible: simulating on "
                  "gloo CPU ranks (simulate_on_cpu=False runs on the card)",
                  flush=True)
    if simulate_on_cpu:
        device_counts = device_counts or _default_counts(8)
        base_dir = f"{base_dir}/simulated_cpu"
    else:
        cards = _cards()
        wanted = device_counts or _default_counts(cards)
        device_counts = [n for n in wanted if n <= cards]
        if not device_counts:
            raise RuntimeError(
                f"the scaling sweep wants {wanted} card(s) and {cards} "
                "is visible: pass --simulate-cpu (simulate_on_cpu=True) "
                "to run it on gloo CPU ranks")
        if device_counts != wanted:
            print(f"[scaling] {cards} card(s) visible: running counts "
                  f"{device_counts} of {wanted} (--simulate-cpu runs all "
                  "on gloo CPU ranks)", flush=True)
    jobs = [models] if isinstance(models, str) else list(models)
    label = "simulated-cpu" if simulate_on_cpu else "cuda"
    for model in jobs:
        for n in device_counts:
            cmd = [
                sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(n),
                "-m", "hyperion_tpu_torch.cli.main", "train",
                "--model", model, "--epochs", str(epochs),
                "--base_dir", base_dir, "--data_dir", data_dir,
                "--devices", str(n),
                "--steps-per-epoch", str(steps_per_epoch),
                *_JOB_EXTRA_FLAGS.get(model, ()),
            ]
            if batch_size:
                cmd += ["--batch_size", str(batch_size)]
            if not validate:
                cmd += ["--no-validate"]
            if simulate_on_cpu:
                cmd += ["--device", "cpu"]
            print(f"[scaling] {model} x{n} ({label}): {' '.join(cmd[2:])}",
                  flush=True)
            try:
                subprocess.run(cmd, check=True)
            except subprocess.CalledProcessError as e:
                # one failed count must not stop the sweep
                print(f"[scaling] {model} with {n} device(s) failed: {e}",
                      flush=True)
            time.sleep(2)  # settle, as the reference does
    return create_scaling_report(f"{base_dir}/distributed")
