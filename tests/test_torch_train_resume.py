"""The port's epoch loop on the CPU (`hyperion_tpu_torch/train/trainer.py`):
a preempted-and-resumed run ends bit-identical to an uninterrupted one,
for `train_language_model` and `train_llama` (llama_tiny, LoRA and
full) — final parameters, every step's loss and the CSV's loss column —
with every batch trained once; health snapshots land under `health/`
and are never the resume point; "abort" skips the exports; and the
telemetry events, and the port's `obs doctor` verdicts, match the JAX
trainer's on the same chaos plans (the port's doctor giving the port's
runs the reference doctor's diagnosis).
"""

from __future__ import annotations

import csv
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.checkpoint import io as ckpt
from hyperion_tpu_torch.config import Config
from hyperion_tpu_torch.obs.health import Anomaly
from hyperion_tpu_torch.train import trainer
from hyperion_tpu_torch.train.state import TrainState, make_optimizer

STEPS = 6  # steps an epoch


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Checkpoints add up over a suite: each test's go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def small_lm(monkeypatch):
    """The language_ddp model cut to d 64 (vocab, layers and the rest as
    published), so a CPU run takes seconds."""
    orig = trainer.simple_lm_config
    monkeypatch.setattr(trainer, "simple_lm_config", lambda **kw: orig(
        **{**kw, "d_model": 64, "ff_dim": 256}))


def lm_cfg(base: Path, **train) -> Config:
    cfg = Config()
    t = cfg.train
    t.epochs, t.steps_per_epoch, t.batch_size, t.seq_len = 2, STEPS, 4, 32
    t.base_dir, t.data_dir = str(base), str(base / "no_data")
    cfg.optimization.compile_tier = "jit+pallas"
    for k, v in train.items():
        setattr(t, k, v)
    return cfg


def llama_cfg(base: Path, lora: bool, **train) -> Config:
    cfg = lm_cfg(base, **train)
    cfg.train.model, cfg.train.lora = "llama_tiny", lora
    cfg.train.lora_rank, cfg.train.lora_alpha = 4, 8.0
    cfg.optimization.grad_clip_norm = 1.0
    cfg.train.weight_decay = 0.01
    return cfg


def csv_losses(path: str) -> dict[str, str]:
    """{epoch: loss} of a run's CSV, as written."""
    with open(path) as f:
        return {r[0]: r[1] for r in list(csv.reader(f))[1:]}


def events(base: Path) -> list[dict]:
    return [r for r in map(json.loads, (base / "telemetry.jsonl")
                           .read_text().splitlines())
            if r.get("kind") == "event"]


def assert_params_equal(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def preempt_and_resume(run, cfg_a: Config, cfg_b: Config, at: int):
    """(uninterrupted, [preempted, resumed]) over `run(cfg)`."""
    ref = run(cfg_a)
    cfg_b.train.chaos = f"sigterm@step={at}"
    first = run(cfg_b)
    cfg_b.train.chaos = ""
    second = run(cfg_b)
    return ref, [first, second]


def check_resume(ref, parts, at: int, base_a: Path, base_b: Path) -> None:
    first, second = parts
    assert first.preempted is True and second.preempted is False
    # every batch trained once, each step's loss bit-identical
    assert len(first.step_losses) == at
    assert first.step_losses + second.step_losses == ref.step_losses
    assert_params_equal(second.model, ref.model)
    # the loss column: each epoch's row is written by the run that
    # finished the epoch (run ids have one-second resolution in both
    # packages, so two quick runs may share one CSV file; ROADMAP C)
    rows = first.history + second.history
    assert [(h.epoch, h.loss) for h in rows] == \
        [(h.epoch, h.loss) for h in ref.history]
    want = csv_losses(ref.csv_path)
    assert csv_losses(second.csv_path) == {
        str(h.epoch): want[str(h.epoch)] for h in second.history}
    resumed = [e for e in events(base_b) if e["name"] == "resumed"]
    assert [(e["step"], e["epoch"]) for e in resumed] == \
        [(at, at // STEPS)]


@pytest.mark.parametrize("at", [8, 6, 3], ids=["mid_epoch_2",
                                                "epoch_boundary",
                                                "mid_epoch_1"])
def test_lm_preempt_then_resume_is_bit_identical(small_lm, tmp_path, at):
    def run(cfg):
        return trainer.train_language_model(cfg, device="cpu")

    ref, parts = preempt_and_resume(run, lm_cfg(tmp_path / "a"),
                                    lm_cfg(tmp_path / "b"), at)
    check_resume(ref, parts, at, tmp_path / "a", tmp_path / "b")
    # the interrupted run exported nothing; the resumed one did
    a = np.load(tmp_path / "a" / "checkpoints" / "language_ddp_final.npz")
    b = np.load(tmp_path / "b" / "checkpoints" / "language_ddp_final.npz")
    assert a.files == b.files and all(np.array_equal(a[k], b[k])
                                      for k in a.files)


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "full"])
def test_llama_preempt_then_resume_is_bit_identical(tmp_path, lora):
    def run(cfg):
        return trainer.train_llama(cfg, device="cpu")

    ref, parts = preempt_and_resume(run, llama_cfg(tmp_path / "a", lora),
                                    llama_cfg(tmp_path / "b", lora), 8)
    check_resume(ref, parts, 8, tmp_path / "a", tmp_path / "b")
    blob = torch.load(tmp_path / "b" / "checkpoints" / "llama_1dev" /
                      "step_00000012" / ckpt.SHARD_FILE.format(rank=0, world=1),
                      weights_only=True)
    # the frozen base rides in every checkpoint, as the reference's
    # orbax tree holds it; AdamW state exists for the trained leaves only
    keys = blob["entries"]
    assert "model/layers.0.attn.q_proj.weight" in keys
    n_model = sum(k.startswith("model/") for k in keys)
    n_trained = sum(p.requires_grad for p in ref.model.parameters())
    assert len({k.rpartition("/")[0] for k in keys
                if k.startswith("adamw/")}) == n_trained
    assert (n_trained < n_model) == lora


def test_health_snapshot_lands_under_health_and_is_never_resumed(
        small_lm, tmp_path, monkeypatch):
    """A non-fatal escalation under policy "checkpoint" saves the state
    under `checkpoints/<job>/health/`; the walk-back never picks it."""
    real = trainer.HealthMonitor

    class SpikeAt8(real):
        def observe_step(self, step, **kw):
            action = super().observe_step(step, **kw)
            if step != 8:
                return action
            anom = Anomaly("loss_spike", step, 99.0, {"z": 9.0}, False)
            self.anomalies.append(anom)
            self.last_escalated = [anom]
            return "checkpoint"

    monkeypatch.setattr(trainer, "HealthMonitor", SpikeAt8)
    res = trainer.train_language_model(
        lm_cfg(tmp_path, health_policy="checkpoint"), device="cpu")
    root = Path(res.checkpoint_dir)
    assert root.name == "language_ddp_1dev"
    assert ckpt.latest_step(root / "health") == 9
    assert ckpt.latest_step(root) == 12
    # with the last epoch save gone, the walk-back lands on the epoch-1
    # save, not the newer health snapshot
    shutil.rmtree(root / "step_00000012")
    template = TrainState(0, res.model,
                          make_optimizer(res.model.parameters(), 1e-3))
    assert ckpt.restore(root, template).step == STEPS


def test_abort_skips_the_exports(small_lm, tmp_path):
    res = trainer.train_language_model(
        lm_cfg(tmp_path, chaos="nan_loss@step=8", health_policy="abort"),
        device="cpu")
    assert res.preempted == "health_abort"
    assert [h.epoch for h in res.history] == [1]
    assert not (tmp_path / "checkpoints" / "language_ddp_final.npz").exists()
    names = [e["name"] for e in events(tmp_path)]
    assert names.count("health_abort") == 1 and "health" in names
    end = events(tmp_path)[-1]
    assert end["name"] == "train_end" and end["preempted"] == "health_abort"
    # the epoch-1 save committed on the way out; nothing after it
    assert ckpt.latest_step(res.checkpoint_dir) == STEPS


# ----------------------------------------- against the JAX trainer


JAX_SHAPE = dict(epochs=2, steps_per_epoch=2, batch_size=8, seq_len=16,
                 validate=False)
# attributes both trainers stamp alike (the JAX run's backend and
# device count differ by construction: a forced 8-device CPU mesh)
EVENT_KEYS = {"train_start": ("job", "batch_size", "seq_len", "epochs",
                              "attempt"),
              "preempt_signal": ("signal", "attempt"),
              "preempted": ("epoch", "mid_epoch", "steps_done"),
              "resumed": ("step", "epoch"),
              "health": ("step", "anomaly", "fatal", "action"),
              "health_abort": ("epoch", "steps_done", "anomalies", "fatal",
                               "steps_observed"),
              "train_end": ("preempted", "epochs_run")}


def _shape(base: Path) -> list[tuple]:
    return [(e["name"], tuple(e.get(k) for k in EVENT_KEYS[e["name"]]))
            for e in events(base) if e["name"] in EVENT_KEYS]


def _jax_run(base: Path, **train):
    from hyperion_tpu.config import Config as JaxConfig
    from hyperion_tpu.train.trainer import train_language_model

    cfg = JaxConfig()
    for k, v in {**JAX_SHAPE, **train}.items():
        setattr(cfg.train, k, v)
    cfg.train.base_dir = str(base)
    cfg.train.data_dir = str(base / "no_data")
    return train_language_model(cfg)


def _port_run(base: Path, **train):
    cfg = lm_cfg(base, **{**JAX_SHAPE, **train})
    return trainer.train_language_model(cfg, device="cpu")


@pytest.fixture(scope="module")
def plan_runs(tmp_path_factory, mesh_dp):
    """Each package through the same plans: `sigterm@step=3` then a
    plain rerun (preempted, resumed, completed), and `nan_loss@step=2`
    under "abort" (diverged)."""
    import hyperion_tpu_torch.train.trainer as port

    orig = port.simple_lm_config
    port.simple_lm_config = lambda **kw: orig(**{**kw, "d_model": 64,
                                                 "ff_dim": 256})
    out = {}
    try:
        for name, run in (("jax", _jax_run), ("port", _port_run)):
            root = tmp_path_factory.mktemp(name)
            out[name] = (root, None, None)
            first = run(root / "preempt", chaos="sigterm@step=3")
            second = run(root / "preempt")
            run(root / "abort", chaos="nan_loss@step=2",
                health_policy="abort")
            out[name] = (root, first.run_id, second.run_id)
    finally:
        port.simple_lm_config = orig
    yield out
    for root, *_ in out.values():
        shutil.rmtree(root, ignore_errors=True)


def test_telemetry_events_match_the_jax_trainer(plan_runs):
    (jroot, *_), (proot, *_) = plan_runs["jax"], plan_runs["port"]
    for plan in ("preempt", "abort"):
        assert _shape(proot / plan) == _shape(jroot / plan), plan
    names = [n for n, _ in _shape(proot / "preempt")]
    assert names == ["train_start", "preempt_signal", "preempted",
                     "train_end", "train_start", "resumed", "train_end"]


def test_obs_doctor_gives_the_port_runs_the_jax_verdicts(plan_runs):
    """The reference's doctor on the JAX runs is the yardstick; the
    port's doctor on the port's runs gives its verdicts, and on the
    port's directories the two doctors agree in every field."""
    from hyperion_tpu.obs.doctor import diagnose as jdiagnose
    from hyperion_tpu_torch.obs.doctor import diagnose

    now = time.time()
    verdicts = {}
    for name, (root, first, second) in plan_runs.items():
        doctor = diagnose if name == "port" else jdiagnose
        verdicts[name] = (
            doctor(root / "preempt", run=first, now=now)["verdict"],
            doctor(root / "preempt", run=second, now=now)["verdict"],
            doctor(root / "abort", now=now)["verdict"])
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"] == ("healthy", "healthy", "diverged")
    root, first, second = plan_runs["port"]
    for target, run in ((root / "preempt", first),
                        (root / "preempt", second), (root / "abort", None)):
        assert diagnose(target, run=run, now=now) \
            == jdiagnose(target, run=run, now=now)
