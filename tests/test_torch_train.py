"""The port's training slice against the JAX package's, on the CPU.

Weights cross over with `params_from_jax`; data, ids and masks are made
with numpy from a seed and handed to both packages. The JAX side runs
its Pallas kernels in interpret mode (`norm_impl`/`loss_impl` "pallas"),
as tests/test_pallas_kernels.py runs them; the port's wrappers run
their plain versions on CPU tensors. Dropout is off wherever outputs
are compared: the two packages' dropout bits cannot agree.

Tolerances: fp32 logits 1e-5 (the frameworks sum matmuls and softmaxes
in other orders); bf16 logits within 5e-2 of the largest logit (bf16
rounds at other places in the two frameworks); losses 1e-6; one train
step's loss 1e-5 relative and each gradient leaf 1e-4 of its largest
entry; optimizer updates 1e-6; data arrays, batch order and CSV headers
exactly.
"""

from __future__ import annotations

import csv
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperion_tpu.checkpoint.io import load_gathered as jax_load_gathered
from hyperion_tpu.data.sharding import ShardedBatches as JaxBatches
from hyperion_tpu.data.text import load_wikitext2 as jax_load
from hyperion_tpu.data.text import synthetic_lm_split as jax_synthetic
from hyperion_tpu.metrics.csv_logger import SCHEMAS as JAX_SCHEMAS
from hyperion_tpu.metrics.csv_logger import CsvLogger as JaxCsvLogger
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.train.losses import next_token_loss as jax_next_token_loss
from hyperion_tpu.train.state import make_optimizer as jax_make_optimizer
from hyperion_tpu_torch.checkpoint import integrity
from hyperion_tpu_torch.checkpoint.io import export_gathered, load_gathered
from hyperion_tpu_torch.config import Config
from hyperion_tpu_torch.data.recordio import write_records
from hyperion_tpu_torch.data.sharding import ShardedBatches
from hyperion_tpu_torch.data.text import load_wikitext2, synthetic_lm_split
from hyperion_tpu_torch.metrics.csv_logger import SCHEMAS, CsvLogger
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.ops.attention import (
    dot_product_attention,
    select_attention_impl,
)
from hyperion_tpu_torch.train.losses import next_token_loss
from hyperion_tpu_torch.train.state import TrainState, make_optimizer
from hyperion_tpu_torch.train.step import make_train_step
from hyperion_tpu_torch.train.trainer import _tier_impls, train_language_model

TINY = dict(vocab_size=1000, d_model=32, n_heads=2, n_layers=2, ff_dim=64,
            max_len=16, dropout=0.0)


def _batch(B=3, T=16, V=1000, seed=0):
    """ids [B, T] int32 and a right-padded mask with one short row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    lengths = np.array([T] + list(rng.integers(T // 2, T, B - 1)))
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int8)
    return ids, mask


def _pair(norm_impl="pallas", dtype="float32", **kw):
    """(jax model, its numpy params, the port model on those weights)."""
    cfg_kw = dict(TINY, norm_impl=norm_impl, dtype=dtype, **kw)
    jmodel = jt.TransformerLM(jt.simple_lm_config(**cfg_kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(0)))
    cfg = tt.simple_lm_config(**cfg_kw)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, cfg))
    return jmodel, params, model


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestData:
    @pytest.mark.parametrize("n, seq, vocab, seed", [
        (64, 128, 50257, 0), (17, 9, 1000, 3)])
    def test_synthetic_split_is_bit_identical(self, n, seq, vocab, seed):
        ref = jax_synthetic(n, seq_len=seq, vocab_size=vocab, seed=seed)
        out = synthetic_lm_split(n, seq_len=seq, vocab_size=vocab, seed=seed)
        np.testing.assert_array_equal(out.input_ids, ref.input_ids)
        np.testing.assert_array_equal(out.attention_mask, ref.attention_mask)

    @pytest.mark.parametrize("shuffle", [True, False])
    def test_epoch_order_matches_sharded_batches(self, mesh_dp, shuffle):
        split = synthetic_lm_split(70, seq_len=8, vocab_size=500, seed=1)
        ref = JaxBatches(split.arrays(), 16, mesh_dp, shuffle=shuffle, seed=5)
        out = ShardedBatches(split.arrays(), 16, "cpu", shuffle=shuffle,
                             seed=5)
        assert len(out) == len(ref) == 4  # drop-last
        for epoch, start in ((0, 0), (1, 0), (1, 2)):
            got = list(out.epoch(epoch, start))
            want = list(ref.epoch(epoch, start))
            assert len(got) == len(want) == 4 - start
            for g, w in zip(got, want):
                for k in ("input_ids", "attention_mask"):
                    np.testing.assert_array_equal(g[k].numpy(),
                                                  np.asarray(w[k]))

    def test_search_order(self, tmp_path):
        base = tmp_path / "wikitext2_tokenized"
        base.mkdir()
        split = synthetic_lm_split(5, seq_len=8, seed=9)
        np.savez(base / "validation.npz", input_ids=split.input_ids,
                 attention_mask=split.attention_mask)
        got = load_wikitext2(tmp_path, seq_len=8, seed=2)
        assert got["train"].source == "synthetic"
        np.testing.assert_array_equal(
            got["train"].input_ids,
            jax_synthetic(4590, seq_len=8, seed=2).input_ids)
        assert got["validation"].source.startswith("npz:")
        np.testing.assert_array_equal(got["validation"].input_ids,
                                      split.input_ids)
        # a recordio pair (data/prepare.py's) comes first, as in the
        # reference; a truncated one falls through to the next source
        write_records(base / "validation.ids.rio", split.input_ids)
        write_records(base / "validation.mask.rio", split.attention_mask)
        got = load_wikitext2(tmp_path, seq_len=8, seed=2)
        assert got["validation"].source.startswith("recordio:")
        np.testing.assert_array_equal(got["validation"].attention_mask,
                                      split.attention_mask)
        rio = base / "validation.ids.rio"
        rio.write_bytes(rio.read_bytes()[:-3])
        got = load_wikitext2(tmp_path, seq_len=8, seed=2)
        assert got["validation"].source.startswith("npz:")
        want = jax_load(tmp_path, seq_len=8, seed=2)
        assert want["validation"].source.startswith("npz:")

    def test_arrow_split_without_pyarrow_raises(self, tmp_path,
                                                monkeypatch):
        """A split on disk is never replaced by synthetic data: without
        pyarrow the port's own reader reads it, and a damaged file
        raises."""
        split_dir = tmp_path / "wikitext2_tokenized" / "validation"
        split_dir.mkdir(parents=True)
        (split_dir / "data-00000-of-00001.arrow").write_bytes(b"")
        monkeypatch.setitem(sys.modules, "pyarrow", None)
        with pytest.raises(ValueError, match="no schema"):
            load_wikitext2(tmp_path, splits=("validation",))


class TestAttention:
    @pytest.mark.parametrize("seq, hd, mode, impl", [
        (128, 64, "train", "xla"), (4096, 64, "train", "pallas"),
        (4096, 64, "fwd", "xla"), (8192, 128, "fwd", "pallas"),
        (4100, 64, "train", "xla"), (4096, 256, "train", "xla")])
    def test_select_attention_impl(self, seq, hd, mode, impl):
        from hyperion_tpu.ops.attention import select_attention_impl as ref

        assert select_attention_impl(seq, hd, mode) == ref(seq, hd, mode)
        assert select_attention_impl(seq, hd, mode) == impl

    @pytest.mark.parametrize("impl, item", [
        ("ring", "needs an active mesh"),
        ("ulysses:pallas", "needs an active mesh")])
    def test_unported_impls_raise(self, impl, item):
        """The sequence-parallel impls run over the active mesh's seq
        axis (tests/test_torch_seq_parallel.py); with none they raise the
        reference's error, never a quiet fallback to the dense one."""
        from hyperion_tpu_torch.runtime.mesh import activate_mesh

        q = torch.zeros(1, 4, 2, 8)
        with activate_mesh(None), pytest.raises(ValueError, match=item):
            dot_product_attention(q, q, q, causal=True, impl=impl)

    def test_pallas_impl_matches_the_jax_flash_kernel(self):
        """impl="pallas" reaches the port's flash attention, held to the
        JAX kernel (interpret mode) at the reference's 2e-5."""
        from hyperion_tpu.ops.attention import (
            dot_product_attention as jax_dpa,
        )

        q, k, v = (np.random.default_rng(i).standard_normal(
            (2, 32, 2, 8)).astype(np.float32) for i in range(3))
        ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, impl="pallas")
        out = dot_product_attention(_t(q), _t(k), _t(v), causal=True,
                                    impl="pallas")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


class TestTransformerLM:
    @pytest.mark.parametrize("norm_impl", ["xla", "pallas"])
    def test_fp32_logits_match_jax(self, norm_impl):
        jmodel, params, model = _pair(norm_impl)
        ids, mask = _batch()
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                      padding_mask=jnp.asarray(mask)))
        with torch.no_grad():
            out = model(_t(ids), padding_mask=_t(mask)).numpy()
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("norm_impl", ["xla", "pallas"])
    def test_bf16_logits_close_to_jax(self, norm_impl):
        jmodel, params, model = _pair(norm_impl, dtype="bfloat16")
        ids, mask = _batch(seed=1)
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                      padding_mask=jnp.asarray(mask)))
        with torch.no_grad():
            out = model(_t(ids), padding_mask=_t(mask)).numpy()
        assert np.abs(out - ref).max() <= 5e-2 * np.abs(ref).max()

    def test_params_round_trip_and_init_shapes(self):
        _, params, model = _pair()
        back = tt.params_to_jax(model)
        flat_ref = jax.tree_util.tree_leaves_with_path(params)
        flat_out = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_ref] == [p for p, _ in flat_out]
        for (_, a), (_, b) in zip(flat_ref, flat_out):
            np.testing.assert_array_equal(np.asarray(a), b)
        fresh = tt.TransformerLM(model.cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        fresh_tree = tt.params_to_jax(fresh)
        assert jax.tree.map(np.shape, fresh_tree) == \
            jax.tree.map(np.shape, jax.device_get(params))
        # flax's initializers, in distribution: normal(0.02) embeddings,
        # xavier-uniform attention, unit norm scales, zero biases
        emb = fresh_tree["tok_emb"]["embedding"]
        assert abs(emb.std() - 0.02) < 2e-3
        q = fresh_tree["block_0"]["attn"]["q_proj"]["kernel"]
        assert np.abs(q).max() <= np.sqrt(6 / (32 + 32))
        assert (fresh_tree["ln_f"]["scale"] == 1).all()
        assert (fresh_tree["lm_head"]["bias"] == 0).all()

    def test_past_max_len_and_unported_options_raise(self):
        model = tt.TransformerLM(tt.simple_lm_config(**TINY), device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            model(torch.zeros(1, 17, dtype=torch.long))
        with pytest.raises(ValueError, match="unknown remat policy"):
            tt.simple_lm_config(remat="offload")
        with pytest.raises(NotImplementedError, match="A9"):
            tt.simple_lm_config(quant="int8")

    @pytest.mark.parametrize("remat", ["full", "dots"])
    def test_remat_logits_and_grads_match_jax(self, remat):
        """fp32, dropout off: a rematerialized model against the JAX
        one with the same policy."""
        jmodel, params, model = _pair(remat=remat)
        ids, mask = _batch(seed=8)

        def jloss(p):
            return jmodel.apply({"params": p}, jnp.asarray(ids),
                                padding_mask=jnp.asarray(mask)).sum()

        ref_grads = jax.device_get(jax.grad(jloss)(params))
        model(_t(ids), padding_mask=_t(mask)).sum().backward()
        grads = tt.state_to_jax(
            {n: p.grad for n, p in model.named_parameters()}, model.cfg)
        leaves = list(zip(jax.tree_util.tree_leaves_with_path(grads),
                          jax.tree_util.tree_leaves_with_path(ref_grads)))
        largest = max(np.abs(np.asarray(r)).max() for _, (_, r) in leaves)
        for (path, g), (_, r) in leaves:
            # k_proj's bias: zero in exact arithmetic (see above)
            scale = max(np.abs(np.asarray(r)).max(), 1e-4 * largest)
            assert np.abs(g - np.asarray(r)).max() <= 1e-4 * scale, path


class TestLoss:
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    @pytest.mark.parametrize("masked", [True, False])
    def test_next_token_loss_matches_jax(self, impl, masked):
        rng = np.random.default_rng(4)
        logits = rng.standard_normal((3, 9, 1000)).astype(np.float32) * 3
        ids, mask = _batch(3, 9, 1000, seed=4)
        m = mask if masked else None
        ref = float(jax_next_token_loss(
            jnp.asarray(logits), jnp.asarray(ids),
            None if m is None else jnp.asarray(m), impl=impl))
        out = float(next_token_loss(_t(logits), _t(ids),
                                    None if m is None else _t(m), impl=impl))
        assert abs(out - ref) <= 1e-6


class TestTrainStep:
    def test_one_step_loss_and_grads_match_jax(self):
        """fp32, dropout off, the jit+pallas tier's impls on both sides."""
        jmodel, params, model = _pair("pallas")
        ids, mask = _batch(4, 16, seed=5)

        def jloss(p):
            logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                                  padding_mask=jnp.asarray(mask))
            return jax_next_token_loss(logits, jnp.asarray(ids),
                                       jnp.asarray(mask), impl="pallas")

        ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
        ref_grads = jax.device_get(ref_grads)

        def loss_fn(m, batch, gen):
            logits = m(batch["input_ids"], padding_mask=batch["attention_mask"],
                       deterministic=gen is None, generator=gen)
            loss = next_token_loss(logits, batch["input_ids"],
                                   batch["attention_mask"], impl="pallas")
            return loss, {"loss": loss}

        opt = make_optimizer(model.parameters(), 2e-4)
        state = TrainState(0, model, opt)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_train_step(loss_fn)
        # the step's own backward, read before the update clears nothing
        loss, _ = loss_fn(model, {"input_ids": _t(ids),
                                  "attention_mask": _t(mask)}, None)
        loss.backward()
        grads = tt.state_to_jax(
            {n: p.grad for n, p in model.named_parameters()}, model.cfg)
        assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss))
        leaves = list(zip(jax.tree_util.tree_leaves_with_path(grads),
                          jax.tree_util.tree_leaves_with_path(ref_grads)))
        largest = max(np.abs(np.asarray(r)).max() for _, (_, r) in leaves)
        for (path, g), (_, r) in leaves:
            r = np.asarray(r)
            # k_proj's bias shifts every logit of a query row alike, so
            # softmax cancels it: its gradient is 0 in exact arithmetic
            # and both packages return rounding noise, held to the
            # largest leaf's scale (1e-8 of it) instead of its own
            scale = max(np.abs(r).max(), 1e-4 * largest)
            assert np.abs(g - r).max() <= 1e-4 * scale, path
        metrics = step(state, {"input_ids": _t(ids),
                               "attention_mask": _t(mask)}, seed=0)
        assert state.step == 1
        assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss))
        assert abs(float(metrics["grad_norm"]) - float(
            optax.global_norm(ref_grads))) <= 1e-4 * float(
            optax.global_norm(ref_grads))
        moved = [k for k, v in model.state_dict().items()
                 if not torch.equal(v, before[k])]
        assert len(moved) == len(before)  # every leaf took the update

    def test_grad_accum_is_the_mean_of_microbatch_grads(self):
        _, _, model = _pair("pallas")
        ids, mask = _batch(4, 16, seed=6)
        batch = {"input_ids": _t(ids), "attention_mask": _t(mask)}

        def loss_fn(m, b, gen):
            logits = m(b["input_ids"], padding_mask=b["attention_mask"])
            loss = next_token_loss(logits, b["input_ids"],
                                   b["attention_mask"], impl="xla")
            return loss, {"loss": loss, "total": loss.new_tensor(2.0)}

        grads = []
        for half in (slice(0, 2), slice(2, 4)):
            model.zero_grad()
            loss_fn(model, {k: v[half] for k, v in batch.items()},
                    None)[0].backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        opt = make_optimizer(model.parameters(), 0.0)
        metrics = make_train_step(loss_fn, grad_accum=2)(
            TrainState(0, model, opt), batch, seed=0)
        for p, a, b in zip(model.parameters(), *grads):
            torch.testing.assert_close(p.grad, (a + b) / 2, atol=1e-7,
                                       rtol=1e-6)
        assert float(metrics["total"]) == 4.0  # a count: summed


class TestOptimizer:
    @pytest.mark.parametrize("schedule, warmup", [
        ("constant", 0), ("cosine", 0), ("warmup_cosine", 1)])
    def test_three_steps_match_optax(self, schedule, warmup):
        rng = np.random.default_rng(7)
        shapes = [(5, 3), (4,), (2, 2, 2)]
        init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        # large enough that the first step clips, small enough that a
        # later one does not
        grads = [[rng.standard_normal(s).astype(np.float32) * scale
                  for s in shapes] for scale in (3.0, 0.1, 1.0)]
        kw = dict(weight_decay=0.01, grad_clip_norm=1.0, schedule=schedule,
                  warmup_steps=warmup, total_steps=3)
        tx = jax_make_optimizer(1e-2, **kw)
        jp = [jnp.asarray(a) for a in init]
        st = tx.init(jp)
        for g in grads:
            upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
            jp = optax.apply_updates(jp, upd)
        params = [torch.nn.Parameter(_t(a.copy())) for a in init]
        opt = make_optimizer(params, 1e-2, **kw)
        for g in grads:
            for p, x in zip(params, g):
                p.grad = _t(x.copy())
            opt.step()
        for p, r in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                       atol=1e-6, rtol=0)

    @pytest.mark.parametrize("kw, match", [
        (dict(schedule="cosine"), "total_steps"),
        (dict(schedule="warmup_cosine", total_steps=3), "warmup_steps"),
        (dict(schedule="linear"), "unknown schedule")])
    def test_schedule_errors_match_the_reference(self, kw, match):
        with pytest.raises(ValueError, match=match):
            jax_make_optimizer(1e-3, **kw)
        with pytest.raises(ValueError, match=match):
            make_optimizer([torch.nn.Parameter(torch.zeros(1))], 1e-3, **kw)


class TestTrainer:
    def test_csv_header_matches_jax(self, tmp_path):
        assert SCHEMAS == JAX_SCHEMAS
        schema = SCHEMAS["language_ddp"] + ("val_loss", "val_ppl")
        ref = JaxCsvLogger("language_ddp", 1, tmp_path / "jax",
                           schema=JAX_SCHEMAS["language_ddp"]
                           + ("val_loss", "val_ppl"), run="r")
        out = CsvLogger("language_ddp", 1, tmp_path / "port", schema=schema,
                        run="r")
        ref.log(epoch=1, loss=1.5, duration_s=2.25, gpus=1, val_loss=1.0,
                val_ppl=2.718)
        out.log(epoch=1, loss=1.5, duration_s=2.25, gpus=1, val_loss=1.0,
                val_ppl=2.718)
        assert out.path.read_text() == ref.path.read_text()

    def test_tier_impls_match_the_reference(self):
        from hyperion_tpu.config import Config as JaxConfig
        from hyperion_tpu.train.trainer import _tier_impls as jax_tier_impls

        for tier in ("jit", "jit+pallas"):
            for attn in (None, "xla"):
                jc, pc = JaxConfig(), Config()
                jc.optimization.compile_tier = pc.optimization.compile_tier \
                    = tier
                jc.optimization.attention_impl = \
                    pc.optimization.attention_impl = attn
                assert _tier_impls(pc) == jax_tier_impls(jc)

    def test_long_train_config_runs_flash_at_d64(self, tmp_path):
        """chip_smoke.py's long-context phase: the language_ddp model at
        4096 tokens, whose "auto" attention resolves to the flash kernel
        (the reference's rule, `hyperion_tpu/ops/attention.py`) at head_dim
        64. Builds the config only; trains nothing."""
        import chip_smoke
        from hyperion_tpu.ops.attention import (
            select_attention_impl as jax_select,
        )

        cfg = chip_smoke.long_train_config(tmp_path / "long")
        lm = tt.simple_lm_config(max_len=cfg.train.seq_len,
                                 **{k: v for k, v in _tier_impls(cfg).items()
                                    if k != "loss_impl"})
        head_dim = lm.d_model // lm.n_heads
        assert (cfg.train.seq_len, cfg.train.batch_size, head_dim,
                cfg.optimization.precision) == (4096, 8, 64, "bf16")
        assert lm.attention_impl == "auto"
        assert select_attention_impl(cfg.train.seq_len, head_dim) \
            == jax_select(cfg.train.seq_len, head_dim) == "pallas"

    def test_train_language_model_on_cpu(self, tmp_path):
        cfg = Config()
        cfg.train.epochs = 1
        cfg.train.steps_per_epoch = 2
        cfg.train.batch_size = 2
        cfg.train.base_dir = str(tmp_path)
        cfg.optimization.compile_tier = "jit+pallas"
        res = train_language_model(cfg, device="cpu")
        assert np.isfinite(res.final_loss) and len(res.step_losses) == 2
        assert res.step_ms == []  # CUDA events only on a card
        with open(res.csv_path) as f:
            rows = list(csv.reader(f))
        assert tuple(rows[0]) == JAX_SCHEMAS["language_ddp"] + (
            "val_loss", "val_ppl")
        assert len(rows) == 2 and rows[1][0] == "1"
        assert np.isfinite(float(rows[1][4]))  # val_loss: 2 eval batches
        recs = [json.loads(x) for x in
                (tmp_path / "telemetry.jsonl").read_text().splitlines()]
        names = [r["name"] for r in recs]
        for name in ("train_start", "epoch", "train_step", "eval",
                     "train_end"):
            assert name in names
        assert names.count("train_step") == 2
        assert json.loads((tmp_path / "heartbeat.json").read_text())[
            "phase"] == "done"
        npz = tmp_path / "checkpoints" / "language_ddp_final.npz"
        exported = jax_load_gathered(npz)
        jmodel = jt.TransformerLM(jt.simple_lm_config())
        shapes = jax.eval_shape(jmodel.init_params, jax.random.key(0))
        assert jax.tree.map(np.shape, exported) == \
            jax.tree.map(lambda s: s.shape, shapes)
        assert jax.tree.structure(load_gathered(npz)) == \
            jax.tree.structure(exported)
        # the epoch's train-state checkpoint verified; its 329 MB go now
        # rather than with pytest's retained temp dirs
        ckpts = tmp_path / "checkpoints" / "language_ddp_1dev"
        assert integrity.verify(ckpts / "step_00000002")[0]
        shutil.rmtree(tmp_path / "checkpoints")

    @pytest.mark.parametrize("field, value, item", [
        ("moe_experts", 4, "_moe4x2")])
    def test_unported_features_raise(self, tmp_path, field, value, item,
                                     monkeypatch):
        """`moe_experts` trains the MoE LM (no longer a refusal): two
        steps on the CPU at narrow widths, the CSV's `lm_loss` and
        `aux_loss` columns as the reference writes them, the export's
        sparse block in the flax tree, the checkpoints under the tree
        tag (`_moe{E}x{every}`)."""
        from hyperion_tpu_torch.train import trainer

        monkeypatch.setattr(trainer, "simple_lm_config", lambda **kw: (
            tt.simple_lm_config(**{**kw, "d_model": 32, "ff_dim": 64})))
        cfg = Config()
        cfg.train.epochs, cfg.train.steps_per_epoch = 1, 2
        cfg.train.batch_size, cfg.train.seq_len = 4, 16
        cfg.train.base_dir = str(tmp_path)
        cfg.train.data_dir = str(tmp_path / "none")
        cfg.optimization.compile_tier = "jit+pallas"
        setattr(cfg.train, field, value)
        res = train_language_model(cfg, device="cpu")
        assert len(res.step_losses) == 2 and np.isfinite(res.final_loss)
        with open(res.csv_path) as f:
            rows = list(csv.DictReader(f))
        assert list(rows[0])[-4:] == ["lm_loss", "aux_loss", "val_loss",
                                      "val_ppl"]
        aux = float(rows[0]["aux_loss"]) / 0.01  # over aux_weight
        assert 0.9 < aux < 4.0
        tree = load_gathered(tmp_path / "checkpoints"
                             / f"language_ddp{item}_final.npz")
        assert tree["moe_block_1"]["experts"]["wi"].shape == (4, 32, 64)
        assert "block_0" in tree and "moe_block_1" in tree
        assert (tmp_path / "checkpoints" / f"language_ddp_1dev{item}").is_dir()

    def test_export_round_trips_through_the_jax_reader(self, tmp_path):
        _, params, model = _pair()
        path = export_gathered(tmp_path / "m.npz", tt.params_to_jax(model))
        back = jax_load_gathered(path)
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_leaves_with_path(params),
                jax.tree_util.tree_leaves_with_path(back)):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), b)
