"""The cifar job (`train/trainer.py` `train_cifar_model`) against the
JAX package's trainer and train step, on the CPU.

  * Two steps of `train_cifar_model` and one validation pass, the
    trainers' ResNet-18 cut to width 8 (stages and stem as published)
    in both packages, the port's weights the JAX init's: the per-step
    losses, the accuracy counts (the CSV's `accuracy`, `val_loss` and
    `val_accuracy`), the final params (both trainers' `{job}_final.npz`
    exports, params only) and the flax-rule BatchNorm statistics.
  * The same step on gloo worlds 2 and 4 (`tests/torch_parallel_
    workers.py` `cifar_run`) against the JAX step on data-parallel
    sub-meshes of the 8 host devices, where a BatchNorm's statistics
    are global over the batch: the port's all-reduce them.
  * A preempted and resumed cifar run ends bit-identical to an
    uninterrupted one, the BatchNorm statistics and accuracy included.
  * `--dry-init`'s plan equals the JAX plan, `batch_stats_gb` included.

fp32 throughout. Tolerances: losses rtol 1e-5; params and statistics
after two AdamW steps at the job's learning rate 1e-3 rtol 1e-5 with
atol 1e-6, except that AdamW divides each element's gradient by its own
magnitude, so an element whose gradient is rounding noise in both
packages moves by the sign of that noise: held to AdamW's bound, lr a
step (`_assert_tree_close`). Accuracy counts are integers and equal.
"""

from __future__ import annotations

import csv
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from hyperion_tpu.models import resnet as jr
from hyperion_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from hyperion_tpu.runtime.mesh import batch_sharding, make_abstract_mesh \
    as jax_abstract, make_mesh as jax_make_mesh
from hyperion_tpu.train import trainer as jtrainer
from hyperion_tpu.train.losses import classification_loss as jax_loss
from hyperion_tpu.train.state import create_train_state
from hyperion_tpu.train.state import make_optimizer as jax_optimizer
from hyperion_tpu.train.state import plan_train_state as jax_plan
from hyperion_tpu.train.step import make_train_step as jax_train_step
from hyperion_tpu_torch.checkpoint.io import load_gathered
from hyperion_tpu_torch.config import Config
from hyperion_tpu_torch.models import resnet as tr
from hyperion_tpu_torch.runtime.mesh import MeshSpec, make_abstract_mesh
from hyperion_tpu_torch.testing.ranks import run_ranks
from hyperion_tpu_torch.train import trainer
from hyperion_tpu_torch.train.state import plan_train_state
from tests import torch_parallel_workers as W
from tests.test_torch_train_resume import assert_params_equal

WIDTH = 8
LR = 1e-3
STEPS, BATCH = 2, 8


def _flat(tree: dict) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _assert_tree_close(got: dict, want: dict, steps: int) -> None:
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        bad = ~np.isclose(got[k], w, rtol=1e-5, atol=1e-6)
        # AdamW's sign-of-noise moves: at most lr a step
        assert np.all(np.abs(got[k] - w)[bad] <= 2 * steps * LR), k
        assert bad.mean() <= 0.01, (k, bad.mean())


def _cfg(base: Path, **train) -> Config:
    cfg = Config()
    t = cfg.train
    t.epochs, t.steps_per_epoch, t.batch_size, t.learning_rate = \
        1, STEPS, BATCH, LR
    t.base_dir, t.data_dir = str(base), str(base / "no_data")
    cfg.optimization.precision = "fp32"
    for k, v in train.items():
        setattr(t, k, v)
    return cfg


def _narrow_jax(dtype="float32"):
    return jr.ResNet(jr.ResNetConfig(width=WIDTH, dtype=dtype))


@pytest.fixture
def narrow(monkeypatch):
    """Both trainers' ResNet-18 at width 8; the port's `init_params`
    loads the JAX init (the JAX trainer's seed-0 variables)."""
    variables = jax.device_get(jax.jit(_narrow_jax().init_variables)(
        jax.random.key(0)))
    monkeypatch.setattr(jtrainer, "resnet18",
                        lambda dtype="float32": _narrow_jax(dtype))

    def port_model(dtype="float32", device=None):
        model = tr.resnet18(dtype=dtype, device=device, width=WIDTH)
        model.init_params = lambda gen: model.load_state_dict(
            tr.params_from_jax(variables)) and model
        return model

    monkeypatch.setattr(trainer, "resnet18", port_model)
    return variables


def _csv(path) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def test_two_steps_match_the_jax_trainer(narrow, tmp_path, monkeypatch):
    jsteps = []
    orig = jtrainer.make_train_step

    def recording(*a, **kw):
        step = orig(*a, **kw)

        def run(state, batch, rng):
            new, m = step(state, batch, rng)
            jsteps.append((jax.device_get(m), jax.device_get(
                {"params": new.params, "batch_stats": new.batch_stats})))
            return new, m
        return run

    monkeypatch.setattr(jtrainer, "make_train_step", recording)
    from hyperion_tpu.config import Config as JaxConfig

    jcfg = JaxConfig()
    for k, v in vars(_cfg(tmp_path / "jax").train).items():
        if hasattr(jcfg.train, k):
            setattr(jcfg.train, k, v)
    jcfg.optimization.precision = "fp32"
    jcfg.distributed.max_devices = 1
    want = jtrainer.train_cifar_model(jcfg, "cifar_ddp")
    got = trainer.train_cifar_model(_cfg(tmp_path / "port"), device="cpu")

    np.testing.assert_allclose(got.step_losses,
                               [float(m["loss"]) for m, _ in jsteps],
                               rtol=1e-5)
    row, jrow = _csv(got.csv_path)[0], _csv(want.csv_path)[0]
    assert list(row) == list(jrow) == [
        "epoch", "loss", "accuracy", "duration_s", "gpus", "val_loss",
        "val_accuracy"]
    correct = sum(float(m["correct"]) for m, _ in jsteps)
    assert float(row["accuracy"]) == pytest.approx(
        100.0 * correct / (STEPS * BATCH), abs=1e-6)
    assert row["accuracy"] == jrow["accuracy"]
    assert row["val_accuracy"] == jrow["val_accuracy"]
    np.testing.assert_allclose(float(row["val_loss"]),
                               float(jrow["val_loss"]), rtol=1e-5)
    final = jsteps[-1][1]
    _assert_tree_close(
        load_gathered(tmp_path / "port/checkpoints/cifar_ddp_final.npz"),
        final["params"], STEPS)
    _assert_tree_close(
        load_gathered(tmp_path / "port/checkpoints/cifar_ddp_final.npz"),
        load_gathered(tmp_path / "jax/checkpoints/cifar_ddp_final.npz"),
        STEPS)
    stats = tr.state_to_jax(dict(got.model.named_buffers()))["batch_stats"]
    _assert_tree_close(stats, final["batch_stats"], STEPS)
    assert got.metrics["gauges"]["samples_per_s"] > 0
    assert got.metrics["gauges"]["flops_per_step"] > 0


# --- gloo worlds ---------------------------------------------------------

TINY = dict(stage_sizes=(1, 1), width=8)


def _batches(seed: int, n: int = 3, size: int = 16):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, size, size, 3)).astype(np.float32),
             rng.integers(0, 10, BATCH).astype(np.int64)) for _ in range(n)]


def _jax_cifar_steps(model, variables, batches, world: int,
                     grad_accum: int = 1):
    mesh = jax_make_mesh(JaxMeshSpec(data=world),
                         devices=jax.devices()[:world])
    opt = jax_optimizer(LR)
    state, sharding = create_train_state(
        lambda r: jax.tree.map(jnp.asarray, variables), opt, mesh,
        jax.random.key(0), policy="fp32", fsdp=False)

    def loss_fn(p, bs, batch, rngs):
        logits, mut = model.apply({"params": p, "batch_stats": bs},
                                  batch["images"], train=True,
                                  mutable=["batch_stats"])
        loss, counts = jax_loss(logits, batch["labels"])
        return loss, ({"loss": loss, **counts}, mut["batch_stats"])

    step = jax_train_step(loss_fn, opt, sharding, donate=False,
                          grad_accum=grad_accum)
    out = {"losses": [], "correct": []}
    for images, labels in batches:
        batch = {"images": jax.device_put(images, batch_sharding(mesh)),
                 "labels": jax.device_put(labels.astype(np.int32),
                                          batch_sharding(mesh))}
        state, m = step(state, batch, jax.random.key(1))
        out["losses"].append(float(m["loss"]))
        out["correct"].append(float(m["correct"]))
    out["state"] = jax.device_get({"params": state.params,
                                   "batch_stats": state.batch_stats})
    return out


@pytest.fixture(scope="module")
def world_runs():
    model = jr.ResNet(jr.ResNetConfig(**TINY))
    variables = jax.device_get(jax.jit(
        lambda r: model.init_variables(r, image_size=16))(jax.random.key(3)))
    batches = _batches(5)
    run = dict(mesh=None, cfg=TINY, variables=variables, batches=batches,
               lr=LR)
    got = {w: run_ranks(W.cifar_run, w, {**run, "mesh": (w, 1, 1)},
                        timeout=180)[0] for w in (2, 4)}
    return model, variables, batches, got


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_matches_the_jax_step_on_its_mesh(world_runs, world):
    """Each rank holds BATCH / world rows; its BatchNorms normalise by
    the whole batch's statistics, as the JAX step's global-view means
    do, so the losses, counts, params and running statistics are the
    one-program step's."""
    model, variables, batches, got = world_runs
    want = _jax_cifar_steps(model, variables, batches, world)
    g = got[world]
    np.testing.assert_allclose(g["losses"], want["losses"], rtol=1e-5)
    assert g["correct"] == want["correct"]
    assert g["total"] == [float(BATCH)] * len(batches)
    _assert_tree_close(g["state"]["params"], want["state"]["params"],
                       len(batches))
    _assert_tree_close(g["state"]["batch_stats"],
                       want["state"]["batch_stats"], len(batches))


def test_grad_accum_carries_the_statistics_between_microbatches():
    """Two microbatches a step in one process: each microbatch's forward
    moves the running statistics on from the last one's, as the JAX
    step's scan carries `batch_stats`; the count metrics sum."""
    model = jr.ResNet(jr.ResNetConfig(**TINY))
    variables = jax.device_get(jax.jit(
        lambda r: model.init_variables(r, image_size=16))(jax.random.key(3)))
    batches = _batches(6, n=2)
    got = W.cifar_run(dict(mesh=None, cfg=TINY, variables=variables,
                           batches=batches, lr=LR, grad_accum=2))
    want = _jax_cifar_steps(model, variables, batches, 1, grad_accum=2)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["correct"] == want["correct"]
    assert got["total"] == [float(BATCH)] * 2
    _assert_tree_close(got["state"]["batch_stats"],
                       want["state"]["batch_stats"], 2)
    _assert_tree_close(got["state"]["params"], want["state"]["params"], 2)


# --- resume and plan ---------------------------------------------------------


@pytest.mark.parametrize("at", [3, 2], ids=["mid_epoch_2", "epoch_boundary"])
def test_preempt_then_resume_is_bit_identical(narrow, tmp_path, at):
    """sigterm@step=N, then a rerun in the same base dir: every batch
    trained once, the BatchNorm statistics carried by the checkpoint,
    the final model bit-identical to an uninterrupted run's, and the
    resumed epoch's row (loss, accuracy and validation) the same."""
    kw = dict(epochs=2)
    ref = trainer.train_cifar_model(_cfg(tmp_path / "a", **kw), device="cpu")
    first = trainer.train_cifar_model(
        _cfg(tmp_path / "b", chaos=f"sigterm@step={at}", **kw), device="cpu")
    time.sleep(1.1)  # run ids have one-second resolution (ROADMAP C)
    second = trainer.train_cifar_model(_cfg(tmp_path / "b", **kw),
                                       device="cpu")
    assert first.preempted is True and second.preempted is False
    assert first.step_losses + second.step_losses == ref.step_losses
    assert_params_equal(second.model, ref.model)  # buffers included
    want = {r["epoch"]: r for r in _csv(ref.csv_path)}
    for r in _csv(second.csv_path):
        for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
            assert r[k] == want[r["epoch"]][k], (r["epoch"], k)
    a = load_gathered(tmp_path / "a/checkpoints/cifar_ddp_final.npz")
    b = load_gathered(tmp_path / "b/checkpoints/cifar_ddp_final.npz")
    for k, v in _flat(a).items():
        assert np.array_equal(v, _flat(b)[k]), k
    shutil.rmtree(tmp_path, ignore_errors=True)


PLAN_KEYS = ("params_gb", "opt_state_gb", "batch_stats_gb", "total_gb",
             "per_device_gb", "param_count", "params_by_dtype_gb")


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 1), (1, 4, 1),
                                   (2, 2, 1)])
def test_plan_equals_the_jax_plan(arch, shape):
    """`--dry-init --model cifar`: ResNet-18 (and ResNet-50, whose
    BatchNorm statistics show at the plan's 1e-4 GB rounding) under the
    "bf16" policy (fp32 masters) on abstract meshes; FSDP when the fsdp
    axis is > 1, as the trainer decides."""
    jmodel = getattr(jr, arch)()
    fsdp = shape[1] > 1
    want = jax_plan(lambda r: jmodel.init_variables(r), jax_optimizer(1e-3),
                    jax_abstract(JaxMeshSpec(*shape)), jax.random.key(0),
                    policy="bf16", fsdp=fsdp)[2]
    model = getattr(tr, arch)(device="meta")
    got = plan_train_state(model, make_abstract_mesh(MeshSpec(*shape)),
                           fsdp=fsdp)
    for k in PLAN_KEYS:
        assert got[k] == want[k], k
    if arch == "resnet50":
        assert got["batch_stats_gb"] > 0
