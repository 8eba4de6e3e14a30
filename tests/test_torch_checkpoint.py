"""The port's train-state checkpoints (`hyperion_tpu_torch/checkpoint/`)
against the reference's contract: the cases of
`tests/test_checkpoint_io.py`, one for one, on the port's `TrainState`,
the port's own commit marker, and the manifest across the packages —
either package's `integrity.verify` passes the other's step dirs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyperion_tpu.checkpoint import integrity as jax_integrity
from hyperion_tpu_torch.checkpoint import integrity
from hyperion_tpu_torch.checkpoint import io as ckpt
from hyperion_tpu_torch.checkpoint.integrity import MANIFEST_NAME, REASON_NAME
from hyperion_tpu_torch.models.transformer_lm import (
    TransformerLM,
    simple_lm_config,
)
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.train.losses import next_token_loss
from hyperion_tpu_torch.train.state import TrainState, make_optimizer
from hyperion_tpu_torch.train.step import make_train_step
from hyperion_tpu_torch.utils import retry as retry_mod

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, ff_dim=32,
            max_len=8, dropout=0.0)


def make_state(seed: int = 0, trained: int = 1, **cfg) -> TrainState:
    """A tiny fp32 LM with its AdamW state populated by `trained`
    steps."""
    model = TransformerLM(simple_lm_config(**{**TINY, **cfg}),
                          device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    state = TrainState(0, model, make_optimizer(model.parameters(), 1e-2))

    def loss_fn(m, b, gen):
        loss = next_token_loss(m(b["input_ids"]), b["input_ids"])
        return loss, {"loss": loss}

    step = make_train_step(loss_fn)
    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (4, 8)), dtype=torch.int32)
    for _ in range(trained):
        step(state, {"input_ids": ids}, 0)
    return state


@pytest.fixture
def state():
    return make_state()


def at_step(state: TrainState, step: int) -> TrainState:
    state.step = step
    return state


def assert_same_state(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    for (na, pa), (nb, pb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    sa, sb = a.optimizer.adamw.state_dict(), b.optimizer.adamw.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for k in sa["state"]:
        for field, v in sa["state"][k].items():
            assert torch.equal(v, sb["state"][k][field]), (k, field)


def corrupt_payload(step_dir: Path) -> Path:
    """Truncate the largest non-manifest file — the partial-write shape
    a mid-save crash leaves."""
    payload = max((p for p in step_dir.rglob("*")
                   if p.is_file() and p.name != MANIFEST_NAME),
                  key=lambda p: p.stat().st_size)
    size = payload.stat().st_size
    with payload.open("r+b") as f:
        f.truncate(size // 2)
    return payload


class TestSaveRestore:
    def test_roundtrip(self, state, tmp_path):
        path = ckpt.save(tmp_path / "ck", at_step(state, 3))
        assert path.name == "step_00000003"
        fresh = make_state(seed=1)
        restored = ckpt.restore(tmp_path / "ck", fresh)
        assert restored is fresh  # filled in place
        assert_same_state(restored, state)

    def test_restore_empty_dir_is_fresh_run(self, state, tmp_path):
        assert ckpt.restore(tmp_path / "nothing", state) is None

    def test_save_writes_committing_manifest(self, state, tmp_path):
        path = ckpt.save(tmp_path / "ck", state)
        m = json.loads((path / MANIFEST_NAME).read_text())
        assert m["v"] == 1 and m["step"] == state.step
        assert m["kernel_rev"] is not None
        assert m["device"] == "cpu" and m["mesh_shape"] is None
        listed = {f["path"] for f in m["files"]}
        on_disk = {p.relative_to(path).as_posix() for p in path.rglob("*")
                   if p.is_file() and p.name != MANIFEST_NAME}
        assert listed == on_disk == {ckpt.STATE_FILE, ckpt.COMMIT_MARKER}
        assert all(f["sha256"] and f["bytes"] >= 0 for f in m["files"])
        assert integrity.verify(path) == (True, "ok")

    def test_save_retries_transient_io(self, state, tmp_path):
        calls = {"n": 0}

        def flaky(tag):
            if tag == "ckpt_save":
                calls["n"] += 1
                if calls["n"] == 1:
                    raise OSError("first attempt eats a storage blip")

        retry_mod.set_fault_injector(flaky)
        try:
            path = ckpt.save(tmp_path / "ck", state)
        finally:
            retry_mod.set_fault_injector(None)
        assert calls["n"] == 2  # failed once, retried, committed
        assert integrity.verify(path)[0]

    def test_restore_of_another_model_leaves_the_template_alone(
            self, state, tmp_path):
        ckpt.save(tmp_path / "ck", state)
        other = make_state(seed=2, d_model=32)
        before = {k: v.clone() for k, v in other.model.state_dict().items()}
        # the walk-back quarantines what does not fit, then finds nothing
        assert ckpt.restore(tmp_path / "ck", other) is None
        assert other.step == 1
        for k, v in other.model.state_dict().items():
            assert torch.equal(v, before[k])
        reason = (tmp_path / "ck" / "step_00000001.corrupt" / REASON_NAME)
        assert "restore failed" in reason.read_text()


class TestAsyncSave:
    """save(wait=False): training-side overlap with a commit point that
    alone decides when a manifest (= verification) exists."""

    def test_manifest_lands_only_at_wait_pending(self, state, tmp_path):
        path = ckpt.save(tmp_path / "ck", state, wait=False)
        assert not (path / MANIFEST_NAME).exists()
        committed = ckpt.wait_pending()
        assert committed == path
        assert integrity.verify(path) == (True, "ok")
        assert ckpt._PENDING is None
        assert ckpt.wait_pending() is None  # idempotent

    def test_next_save_finalizes_previous(self, state, tmp_path):
        root = tmp_path / "ck"
        first = ckpt.save(root, state, wait=False)
        second = ckpt.save(root, at_step(state, state.step + 5))
        assert integrity.verify(first)[0]   # committed by the 2nd save
        assert integrity.verify(second)[0]  # wait=True committed itself

    def test_restore_drains_inflight_save(self, state, tmp_path):
        root = tmp_path / "ck"
        ckpt.save(root, state, wait=False)
        restored = ckpt.restore(root, make_state(seed=1))
        assert restored is not None and restored.step == state.step
        assert_same_state(restored, state)

    def test_async_manifest_records_device_provenance(self, state,
                                                      tmp_path):
        path = ckpt.save(tmp_path / "ck", state, wait=False)
        ckpt.wait_pending()
        m = json.loads((path / MANIFEST_NAME).read_text())
        assert m["device"] == "cpu"

    def test_the_snapshot_is_the_state_at_the_save(self, state, tmp_path):
        """The optimizer updates in place right after an async save: the
        written state is the one at the save."""
        want = {k: v.clone() for k, v in state.model.state_dict().items()}
        path = ckpt.save(tmp_path / "ck", state, wait=False)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        ckpt.wait_pending()
        blob = torch.load(path / ckpt.STATE_FILE, weights_only=True)
        for k, v in want.items():
            assert torch.equal(blob["model"][k], v), k

    def test_span_pair_emitted(self, state, tmp_path):
        tele = tmp_path / "t.jsonl"
        tracer = Tracer(tele, run="r", proc=0)
        ckpt.save(tmp_path / "ck", state, wait=False, tracer=tracer)
        ckpt.wait_pending(tracer=tracer)
        tracer.close()
        spans = [json.loads(line) for line in tele.open()]
        names = [s["name"] for s in spans if s.get("kind") == "span"]
        assert names == ["ckpt_dispatch", "ckpt_commit"]
        commit = [s for s in spans if s.get("name") == "ckpt_commit"][0]
        assert commit["overlap_s"] >= 0.0


class TestAsyncSaveKill:
    """SIGKILL during an in-flight async save never yields a
    manifest-verified corrupt checkpoint, and resume lands on a real
    state: the prior verified step, or the interrupted one when its
    write had finished (adopted by the commit marker)."""

    CHILD = """
import os, signal, sys
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
from test_torch_checkpoint import make_state, at_step
from hyperion_tpu_torch.checkpoint import io

root = sys.argv[1]
state = make_state(d_model=64, ff_dim=256, vocab_size=512)
io.save(root, at_step(state, 0))  # committed + manifest: the fallback
io.save(root, at_step(state, 5), wait=False)
print("DISPATCHED", flush=True)
os.kill(os.getpid(), signal.SIGKILL)  # dies inside the save window
"""

    def test_kill_during_async_save_never_verifies_corrupt(self, tmp_path):
        script = tmp_path / "child.py"
        script.write_text(self.CHILD)
        root = tmp_path / "ck"
        r = subprocess.run([sys.executable, str(script), str(root),
                            str(REPO)], capture_output=True, text=True,
                           timeout=120, env={**os.environ,
                                             "JAX_PLATFORMS": "cpu"})
        assert "DISPATCHED" in r.stdout, r.stderr[-2000:]
        assert r.returncode == -9  # really SIGKILLed mid-save
        for p in root.iterdir():
            if (p / MANIFEST_NAME).exists():
                ok, reason = integrity.verify(p, deep=True)
                assert ok, f"{p.name}: manifest present but {reason}"
        assert integrity.verify(root / "step_00000000")[0]
        restored = ckpt.restore(root, make_state(
            seed=3, d_model=64, ff_dim=256, vocab_size=512))
        assert restored is not None and restored.step in (0, 5)
        assert_same_state(at_step(restored, 0), at_step(make_state(
            d_model=64, ff_dim=256, vocab_size=512), 0))

    def test_kill_after_the_write_leaves_an_adoptable_save(self, state,
                                                           tmp_path):
        """The chaos kill's shape: the write finished (the marker is
        there), the commit point never ran (no manifest)."""
        root = tmp_path / "ck"
        ckpt.save(root, at_step(state, 2))
        path = ckpt.save(root, at_step(state, 4), wait=False)
        ckpt.join_pending()
        ckpt._PENDING = None  # the process died before its commit point
        assert (path / ckpt.COMMIT_MARKER).exists()
        assert not (path / MANIFEST_NAME).exists()
        restored = ckpt.restore(root, make_state(seed=1))
        assert restored.step == 4
        assert integrity.verify(path)[0]  # manifest backfilled


class TestVerification:
    def test_missing_manifest_means_uncommitted(self, state, tmp_path):
        path = ckpt.save(tmp_path / "ck", state)
        (path / MANIFEST_NAME).unlink()
        ok, reason = integrity.verify(path)
        assert not ok and "missing manifest" in reason

    def test_size_and_hash_mismatches(self, state, tmp_path):
        path = ckpt.save(tmp_path / "ck", state)
        corrupt_payload(path)
        ok, reason = integrity.verify(path, deep=False)
        assert not ok and "size mismatch" in reason
        # same size, different bytes: only the deep (hash) check sees it
        path2 = ckpt.save(tmp_path / "ck2", state)
        m = json.loads((path2 / MANIFEST_NAME).read_text())
        target = max(m["files"], key=lambda f: f["bytes"])
        p = path2 / target["path"]
        raw = bytearray(p.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        p.write_bytes(bytes(raw))
        assert integrity.verify(path2, deep=False)[0]
        ok, reason = integrity.verify(path2, deep=True)
        assert not ok and "checksum mismatch" in reason


class TestWalkBack:
    def test_corrupt_latest_falls_back_and_quarantines(self, state,
                                                       tmp_path):
        root = tmp_path / "ck"
        ckpt.save(root, at_step(state, 0))
        newest = ckpt.save(root, at_step(state, 5))
        corrupt_payload(newest)
        restored = ckpt.restore(root, make_state(seed=1))
        assert restored.step == 0  # fell back
        corrupt = root / "step_00000005.corrupt"
        assert corrupt.is_dir() and not newest.exists()
        assert "size mismatch" in (corrupt / REASON_NAME).read_text()

    def test_all_corrupt_returns_none(self, state, tmp_path):
        root = tmp_path / "ck"
        p = ckpt.save(root, at_step(state, 0))
        # a true partial dir: neither the manifest nor the commit marker
        (p / MANIFEST_NAME).unlink()
        (p / ckpt.COMMIT_MARKER).unlink()
        assert ckpt.restore(root, state) is None
        corrupt = root / "step_00000000.corrupt"
        assert corrupt.is_dir()
        assert "partial save" in (corrupt / REASON_NAME).read_text()

    def test_committed_checkpoint_without_manifest_is_adopted(
            self, state, tmp_path):
        root = tmp_path / "ck"
        p = ckpt.save(root, at_step(state, 0))
        (p / MANIFEST_NAME).unlink()
        restored = ckpt.restore(root, make_state(seed=1))
        assert restored is not None and restored.step == 0
        assert p.is_dir() and not (root / "step_00000000.corrupt").exists()
        assert integrity.verify(p)[0]  # backfilled manifest verifies

    def test_explicit_corrupt_step_raises(self, state, tmp_path):
        root = tmp_path / "ck"
        p = ckpt.save(root, at_step(state, 3))
        corrupt_payload(p)
        with pytest.raises(ValueError, match="failed verification"):
            ckpt.restore(root, state, step=3)
        assert p.exists()  # explicit requests never quarantine

    def test_staging_dir_is_never_a_resume_point(self, state, tmp_path):
        root = tmp_path / "ck"
        ckpt.save(root, at_step(state, 2))
        (root / ".step_00000009.tmp").mkdir()  # a kill before the rename
        assert ckpt.latest_step(root) == 2
        assert ckpt.restore(root, make_state(seed=1)).step == 2


class TestLatestStepAndPrune:
    def test_latest_step_ignores_corrupt_and_health(self, state, tmp_path):
        root = tmp_path / "ck"
        ckpt.save(root, at_step(state, 2))
        newest = ckpt.save(root, at_step(state, 7))
        corrupt_payload(newest)
        integrity.quarantine(newest, "test")
        ckpt.save(root / "health", at_step(state, 9))
        assert ckpt.latest_step(root) == 2
        assert ckpt.latest_step(root / "health") == 9

    def test_prune_skips_corrupt_and_protects_newest_verified(
            self, state, tmp_path):
        root = tmp_path / "ck"
        ckpt.save(root, at_step(state, 0))
        ckpt.save(root, at_step(state, 5))
        newest = ckpt.save(root, at_step(state, 9))
        (newest / MANIFEST_NAME).unlink()  # newest never committed
        quarantined = ckpt.save(root, at_step(state, 7))
        corrupt_payload(quarantined)
        integrity.quarantine(quarantined, "test")
        ckpt.prune(root, keep=1)
        names = sorted(p.name for p in root.iterdir())
        assert names == ["step_00000005", "step_00000007.corrupt",
                         "step_00000009"]
        ckpt.prune(root, keep=0)
        assert sorted(p.name for p in root.iterdir()) == [
            "step_00000005", "step_00000007.corrupt"]

    def test_prune_never_touches_health_subdir(self, state, tmp_path):
        root = tmp_path / "ck"
        ckpt.save(root, at_step(state, 0))
        ckpt.save(root, at_step(state, 4))
        ckpt.save(root / "health", at_step(state, 2))
        ckpt.prune(root, keep=1)
        assert ckpt.latest_step(root / "health") == 2
        assert ckpt.latest_step(root) == 4


class TestGatheredExport:
    def test_roundtrip(self, state, tmp_path):
        from hyperion_tpu_torch.models.transformer_lm import params_to_jax

        params = params_to_jax(state.model)
        p = ckpt.export_gathered(tmp_path / "full.npz", params)
        loaded = ckpt.load_gathered(p)
        np.testing.assert_array_equal(loaded["tok_emb"]["embedding"],
                                      params["tok_emb"]["embedding"])
        assert set(loaded) == set(params)


class TestManifestAcrossPackages:
    """`manifest.json` keeps the reference's schema: each package's
    `verify` passes the other's step dirs and catches the other's
    damage."""

    def test_reference_verify_passes_port_step_dirs(self, state, tmp_path):
        sync = ckpt.save(tmp_path / "ck", at_step(state, 1))
        pending = ckpt.save(tmp_path / "ck", at_step(state, 2), wait=False)
        ckpt.wait_pending()
        for path in (sync, pending):
            assert jax_integrity.verify(path) == (True, "ok")
            assert jax_integrity.read_manifest(path)["v"] == \
                jax_integrity.SCHEMA_VERSION
        corrupt_payload(sync)
        ok, reason = jax_integrity.verify(sync)
        assert not ok and "size mismatch" in reason

    def test_port_verify_passes_reference_step_dirs(self, mesh8, tmp_path):
        from hyperion_tpu import checkpoint as jax_ckpt
        from hyperion_tpu.models.transformer_lm import (
            TransformerLM as JaxLM,
        )
        from hyperion_tpu.models.transformer_lm import (
            simple_lm_config as jax_cfg,
        )
        from hyperion_tpu.train.state import create_train_state
        from hyperion_tpu.train.state import make_optimizer as jax_opt

        model = JaxLM(jax_cfg(**TINY))
        st, _ = create_train_state(
            lambda r: {"params": model.init_params(r)}, jax_opt(1e-2),
            mesh8, jax.random.key(0), policy="fp32")
        path = jax_ckpt.save(tmp_path / "ref", st)
        assert integrity.verify(path) == (True, "ok")
        m = integrity.read_manifest(path)
        assert m["v"] == integrity.SCHEMA_VERSION and m["files"]
        corrupt_payload(path)
        assert not integrity.verify(path)[0]
        # and the port's walk-back quarantines a damaged reference dir
        # like its own (the supervisor shares `quarantine`)
        q = integrity.quarantine(path, "test", tracer=None)
        assert q.name.endswith(integrity.CORRUPT_SUFFIX)
        assert q.name == path.name + jax_integrity.CORRUPT_SUFFIX
