"""Sharded checkpoints of the port on the CPU: saved by every rank of
one world, restored onto another world size and layout bit for bit, the
gathered export the JAX package reads, and `language_fsdp` through
`torch.distributed.run` — one CSV, and a SIGTERM, a resume and an end
bit-identical to the run that was not stopped.

Worlds of gloo ranks are spawned by `hyperion_tpu_torch/testing/
ranks.py` (each with its own timeout); the rank functions are in
tests/torch_parallel_workers.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperion_tpu.checkpoint.io import load_gathered as jax_load_gathered
from hyperion_tpu_torch.checkpoint import integrity
from hyperion_tpu_torch.checkpoint.io import load_gathered
from hyperion_tpu_torch.models.transformer_lm import state_to_jax
from hyperion_tpu_torch.testing.ranks import free_port, run_ranks
from tests import torch_parallel_workers as W

REPO = Path(__file__).resolve().parents[1]
# fc1/fc2 and the tables pass the 2^14 FSDP threshold, the rest stays
# replicated: both kinds of shard are in the checkpoint
LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, ff_dim=256,
          max_len=16, dropout=0.0)


def _batches(n=2, B=8, T=16):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 256, (B, T)).astype(np.int64)
        lens = rng.integers(4, T + 1, B)
        out.append((ids, (np.arange(T)[None] < lens[:, None]).astype(
            np.int64)))
    return out


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A world-2 FSDP run's sharded checkpoint, its export and its whole
    state."""
    d = tmp_path_factory.mktemp("sharded")
    run = dict(mesh=(1, 2, 1), fsdp=True, cfg=LM, params=None,
               batches=_batches(), root=str(d / "ckpt"),
               export=str(d / "export.npz"))
    whole = run_ranks(W.ckpt_save_run, 2, run, timeout=180)[0]
    return d, whole


def test_the_save_is_per_rank_shards_under_one_manifest(saved):
    d, whole = saved
    step_dir = d / "ckpt" / f"step_{whole['step']:08d}"
    ok, reason = integrity.verify(step_dir)
    assert ok, reason
    names = sorted(p.name for p in step_dir.iterdir())
    assert names == ["COMMITTED", "manifest.json",
                     "shard-00000-of-00002.pt", "shard-00001-of-00002.pt"]
    manifest = integrity.read_manifest(step_dir)
    assert manifest["mesh_shape"]["fsdp"] == 2 and manifest["world"] == 2


def test_restores_bit_identical_at_world_1(saved):
    """Into a single process's plain state: each tensor assembled from
    both ranks' shards."""
    d, whole = saved
    model = W._lm_model(LM, None)
    state, _, _ = W._state(model, None, False, 1e-3, 1.0, 0.01)
    from hyperion_tpu_torch.checkpoint import io as ckpt

    assert ckpt.restore(d / "ckpt", state) is not None
    _assert_same(W.full_state(state), whole)


@pytest.mark.parametrize("mesh, fsdp", [((1, 4, 1), True),
                                        ((2, 1, 2), False)])
def test_restores_bit_identical_at_world_4(saved, mesh, fsdp):
    """Onto four ranks: FSDP over four, and DDP x TP (2 x 2)."""
    d, whole = saved
    got = run_ranks(W.ckpt_restore_run, 4, dict(
        mesh=mesh, fsdp=fsdp, cfg=LM, root=str(d / "ckpt")),
        timeout=180)[0]
    _assert_same(got, whole)


def test_gathered_export_equals_the_world_1_export(saved, tmp_path):
    """The world-2 export equals the export of the same state at world
    1, and the JAX package's reader loads it."""
    d, whole = saved
    model = W._lm_model(LM, None)
    model.load_state_dict({k[len("model/"):]: v for k, v in whole.items()
                           if k.startswith("model/")})
    from hyperion_tpu_torch.checkpoint.io import export_gathered

    export_gathered(tmp_path / "w1.npz", state_to_jax(model.state_dict(),
                                                      model.cfg))
    a, b = load_gathered(d / "export.npz"), load_gathered(tmp_path / "w1.npz")
    ref = jax_load_gathered(d / "export.npz")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from leaves(v, key)
            else:
                yield key, np.asarray(v)

    la, lb, lr = dict(leaves(a)), dict(leaves(b)), dict(leaves(ref))
    assert set(la) == set(lb) == set(lr)
    for k in la:
        assert np.array_equal(la[k], lb[k]) and np.array_equal(la[k], lr[k]), k
    assert la["lm_head/kernel"].shape == (64, 256)


def _torchrun(base: Path, *extra: str, timeout: float = 240):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "HYPERION_COORD_PORT": str(free_port())}
    env.pop("HYPERION_ATTEMPT", None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(free_port()), "-m",
         "hyperion_tpu_torch.cli.main", "train", "--model", "language_fsdp",
         "--device", "cpu", "--epochs", "2", "--steps-per-epoch", "3",
         "--batch_size", "4", "--seq_len", "16", "--no-validate",
         "--base_dir", str(base), "--data_dir", str(base / "none"), *extra],
        env=env, capture_output=True, text=True, timeout=timeout)


def test_language_fsdp_under_torchrun_resumes_bit_identically(tmp_path):
    """Two gloo ranks through the CLI: the primary writes the one CSV;
    a SIGTERM at step 4 (mid second epoch) saves a sharded checkpoint
    and stops both ranks; the rerun resumes there and its export equals
    the uninterrupted run's, bit for bit."""
    a, b = tmp_path / "a", tmp_path / "b"
    for base in (a, b):
        (base / "none").mkdir(parents=True)
    done = _torchrun(a)
    assert done.returncode == 0, done.stderr[-3000:]
    csvs = list((a / "distributed").glob("*_metrics.csv"))
    assert len(csvs) == 1 and csvs[0].name.startswith("language_fsdp_2gpus")
    assert len(csvs[0].read_text().splitlines()) == 3  # header + 2 epochs
    stopped = _torchrun(b, "--chaos", "sigterm@step=4")
    assert stopped.returncode != 0  # a preempted rank exits 75
    assert "preempted at global step 4" in stopped.stdout, stopped.stdout
    step_dir = b / "checkpoints" / "language_fsdp_2dev" / "step_00000004"
    assert sorted(p.name for p in step_dir.glob("shard-*")) == [
        "shard-00000-of-00002.pt", "shard-00001-of-00002.pt"]
    resumed = _torchrun(b)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "resumed from step 4" in resumed.stdout
    with np.load(a / "checkpoints" / "language_fsdp_final.npz") as ea, \
            np.load(b / "checkpoints" / "language_fsdp_final.npz") as eb:
        assert sorted(ea.files) == sorted(eb.files)
        for k in ea.files:
            assert np.array_equal(ea[k], eb[k]), k
