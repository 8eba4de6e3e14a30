"""The port's Llama against the JAX Llama, weights shared through
`params_from_jax`.

Both sides run `norm_impl="pallas"` (the fused RMSNorm, in interpret
mode on the JAX side) and the JAX side the default
`paged_attn_impl="gather"` (the read the port's plain paged attention
is). Both call forms are held to 2e-5 abs/rel in fp32 — logits and the
K/V caches — for MHA and GQA (`n_kv_heads=2`): the frameworks sum
matmuls and softmaxes in other orders, and the layers amplify that, as
the reference's own kernel-vs-gather bound allows.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hyperion_tpu.models import llama as jl
from hyperion_tpu_torch.checkpoint.io import load_gathered
from hyperion_tpu_torch.infer.generate import model_from_npz
from hyperion_tpu_torch.models import llama as tl

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", params=["mha", "gqa"])
def pair(request):
    kw = {} if request.param == "mha" else {"n_kv_heads": 2}
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64, norm_impl="pallas",
                                           **kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(0), seq=8))
    cfg = tl.llama_tiny_config(max_len=64, norm_impl="pallas", **kw)
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    # jitted: one XLA program per window shape instead of an eager
    # dispatch (and interpret-mode trace) per op
    return jax.jit(jmodel.apply), params, model


def _jcfg(model):
    """The JAX config matching a port model (cache shapes only)."""
    c = model.cfg
    return jl.llama_tiny_config(max_len=c.max_len, n_kv_heads=c.n_kv_heads)


def _close_caches(jcache, tcache):
    for jlayer, tlayer in zip(jcache, tcache):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tlayer[kv].numpy(),
                                       np.asarray(jlayer[kv]), **TOL)


class TestPagedForm:
    def test_three_window_shapes_match_jax(self, pair):
        """Prefill both rows, then a [1, C] chunk at start > 0, a
        [S, k+1] verify window at per-row bases, and a [S, 1] decode
        step — caches threaded forward in each package."""
        japply, params, model = pair
        S, bs, MB = 2, 4, 16
        rng = np.random.default_rng(0)
        bt = rng.permutation(np.arange(1, S * MB + 1)).reshape(S, MB)
        bt = bt.astype(np.int32)
        jcache = jl.init_paged_cache(_jcfg(model), S * MB + 1, bs)
        tcache = tl.init_paged_cache(model.cfg, S * MB + 1, bs, device="cpu")
        steps = [
            (rng.integers(1, 250, (S, 8)), 0, [0, 1]),
            (rng.integers(1, 250, (1, 8)), 8, [0]),
            (rng.integers(1, 250, (S, 4)), np.array([16, 8], np.int32),
             [0, 1]),
            (rng.integers(1, 250, (S, 1)), np.array([20, 12], np.int32),
             [0, 1]),
        ]
        for ids, idx, rows in steps:
            ids = ids.astype(np.int32)
            jlog, jcache = japply(
                {"params": params}, jnp.asarray(ids), cache=jcache,
                cache_index=jnp.asarray(idx), block_tables=jnp.asarray(
                    bt[rows]))
            tlog, tcache = model(torch.from_numpy(ids), cache=tcache,
                                 cache_index=torch.as_tensor(idx),
                                 block_tables=torch.from_numpy(bt[rows]))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
            _close_caches(jcache, tcache)

    def test_positions_beyond_the_table_go_to_the_null_block(self, pair):
        """A window running past the table's coverage (bucket padding)
        writes its overflow into block 0 and leaves mapped blocks
        alone."""
        _, _, model = pair
        bs, MB = 4, 2
        cache = tl.init_paged_cache(model.cfg, 3, bs, device="cpu")
        bt = torch.tensor([[1, 2]], dtype=torch.int32)
        ids = torch.arange(1, 13)[None]   # 12 positions, table holds 8
        model(ids, cache=cache, cache_index=0, block_tables=bt)
        k = cache[0]["k"]
        assert k[1:].abs().sum() > 0 and k[0].abs().sum() > 0
        before = k[1:].clone()
        model(ids, cache=cache, cache_index=0, block_tables=bt)
        assert torch.equal(k[1:], before)  # deterministic, no spill-over


    def test_bucket_padding_past_max_len_keeps_real_rotations(self):
        """A prefix hit at start 24 with a 20-token suffix padded to a
        32 bucket runs the window to position 55 of a 48-row rope table.
        The real rows keep their own rotations (the JAX reference's
        dynamic_slice clamps the whole window instead: ROADMAP C)."""
        cfg = tl.llama_tiny_config(max_len=48)
        model = tl.Llama(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            1, 250, (1, 44)))
        bt = torch.arange(1, 7, dtype=torch.int32)[None]
        out = {}
        for Pb in (20, 32):
            cache = tl.init_paged_cache(cfg, 8, 8, device="cpu")
            model(ids[:, :24], cache=cache, cache_index=0, block_tables=bt)
            buf = torch.zeros(1, Pb, dtype=torch.long)
            buf[0, :20] = ids[0, 24:]
            logits, _ = model(buf, cache=cache, cache_index=24,
                              block_tables=bt)
            out[Pb] = logits[0, :20]
        torch.testing.assert_close(out[32], out[20], atol=1e-6, rtol=1e-6)


class TestContiguousForm:
    def test_scalar_cache_index_matches_jax(self, pair):
        japply, params, model = pair
        # window shapes shared with the paged test: the JAX side's
        # interpret-mode norm traces once per shape
        ids = np.random.default_rng(1).integers(1, 250, (2, 8))
        ids = ids.astype(np.int32)
        jcache = jl.init_cache(_jcfg(model), 2, max_len=16)
        tcache = tl.init_cache(model.cfg, 2, max_len=16, device="cpu")
        for window, idx in ((ids, 0), (ids[:, -1:], 8)):
            jlog, jcache = japply({"params": params},
                                        jnp.asarray(window), cache=jcache,
                                        cache_index=idx)
            tlog, tcache = model(torch.from_numpy(window), cache=tcache,
                                 cache_index=idx)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _close_caches(jcache, tcache)

    def test_vector_cache_index_matches_jax(self, pair):
        japply, params, model = pair
        rng = np.random.default_rng(2)
        prompt = rng.integers(1, 250, (2, 8)).astype(np.int32)
        window = rng.integers(1, 250, (2, 4)).astype(np.int32)
        idx = np.array([8, 5], np.int32)
        jcache = jl.init_cache(_jcfg(model), 2, max_len=16)
        tcache = tl.init_cache(model.cfg, 2, max_len=16, device="cpu")
        _, jcache = japply({"params": params}, jnp.asarray(prompt),
                                 cache=jcache, cache_index=0)
        model(torch.from_numpy(prompt), cache=tcache, cache_index=0)
        jlog, jcache = japply({"params": params}, jnp.asarray(window),
                                    cache=jcache, cache_index=jnp.asarray(idx))
        tlog, tcache = model(torch.from_numpy(window), cache=tcache,
                             cache_index=torch.from_numpy(idx))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _close_caches(jcache, tcache)


class TestWeights:
    def test_npz_round_trip(self, pair, tmp_path):
        """The JAX export format (`/`-joined keys, as export_gathered
        writes it) loads through the port's reader into the same model."""
        japply, params, model = pair
        flat = traverse_util.flatten_dict(params, sep="/")
        path = tmp_path / "tiny.npz"
        np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
        loaded, cached = model_from_npz(load_gathered(path), max_len=64,
                                        dtype="float32", device="cpu")
        assert cached
        # the loader keeps the reference's default norm, the "xla"
        # formula, which in fp32 is the fused one op for op
        assert loaded.cfg == dataclasses.replace(model.cfg, norm_impl="xla")
        ids = torch.arange(1, 8)[None]
        a, _ = loaded(ids, cache=tl.init_cache(loaded.cfg, 1, 8,
                                               device="cpu"), cache_index=0)
        b, _ = model(ids, cache=tl.init_cache(model.cfg, 1, 8, device="cpu"),
                     cache_index=0)
        assert torch.equal(a, b)

    def test_other_layouts_raise(self):
        """A pipeline export raises the reference CLI's message; a layout
        of no model says so (TransformerLM and MoE exports load:
        tests/test_torch_infer.py)."""
        from hyperion_tpu.infer.generate import model_from_npz as jax_load

        for load in (model_from_npz, jax_load):
            with pytest.raises(ValueError, match="pipeline checkpoints are "
                               "not supported by the generation CLI"):
                load({"stages": {}})
        with pytest.raises(ValueError, match="unrecognized"):
            model_from_npz({"w": {}}, device="cpu")

    def test_init_params_is_seeded(self):
        cfg = tl.llama_tiny_config()
        a = tl.Llama(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(3))
        b = tl.Llama(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(3))
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), name
        assert torch.equal(a.final_norm.weight, torch.ones(cfg.d_model))
        assert abs(float(a.lm_head.weight.std()) - 0.02) < 0.002

    @pytest.mark.parametrize("field, value", [("quant", "int8")])
    def test_unported_config_raises(self, field, value):
        """The last option the port lacked, int8 weights, now builds: a
        config with it quantizes the JAX init's weights exactly as the
        JAX package does, and its cached logits match the JAX int8
        model's (fp32, within TOL); an unknown mode still raises."""
        from hyperion_tpu.precision import quant as jq
        from hyperion_tpu_torch.precision import quant as tq

        jcfg = jl.llama_tiny_config(max_len=64, n_kv_heads=2)
        params = jax.device_get(jl.Llama(jcfg).init_params(
            jax.random.key(1), seq=8))
        fcfg = tl.llama_tiny_config(max_len=64, n_kv_heads=2)
        cfg = dataclasses.replace(fcfg, **{field: value})
        qmodel = tl.Llama(cfg, device="cpu")
        qmodel.load_state_dict(tq.quantize_params_like(
            tl.params_from_jax(params, fcfg), qmodel))
        jmodel, jparams = jq.quantize_llama(params, jcfg)
        want = tl.params_from_jax(jax.device_get(jparams), cfg)
        for k, v in qmodel.state_dict().items():
            assert torch.equal(v.to(want[k].dtype), want[k]), k
        ids = np.random.default_rng(7).integers(1, 250, (2, 6))
        ref, _ = jmodel.apply({"params": jparams},
                              jnp.asarray(ids.astype(np.int32)),
                              cache=jl.init_cache(jmodel.cfg, 2, 8),
                              cache_index=0)
        got, _ = qmodel(torch.as_tensor(ids),
                        cache=tl.init_cache(cfg, 2, 8, device="cpu"),
                        cache_index=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        with pytest.raises(ValueError, match="unknown quant mode"):
            tl.llama_tiny_config(**{field: "int4"})

    @pytest.mark.parametrize("field, value", [("lora_rank", 8),
                                              ("remat", True)])
    def test_training_config_leaves_serving_alone(self, pair, field, value):
        """A LoRA (B = 0) or rematerialized model on the same weights
        serves the same logits through the cache."""
        _, params, model = pair
        cfg = dataclasses.replace(model.cfg, **{field: value})
        other = tl.Llama(cfg, device="cpu")
        other.load_state_dict(tl.params_from_jax(params, cfg), strict=False)
        ids = torch.arange(1, 9)[None]
        a, _ = other(ids, cache=tl.init_cache(cfg, 1, 8, device="cpu"),
                     cache_index=0)
        b, _ = model(ids, cache=tl.init_cache(cfg, 1, 8, device="cpu"),
                     cache_index=0)
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    def test_cache_free_forward_matches_jax(self, pair):
        japply, params, model = pair
        ids = np.random.default_rng(3).integers(1, 250, (2, 16))
        mask = np.ones((2, 16), np.int8)
        mask[1, 11:] = 0
        ref = japply({"params": params}, jnp.asarray(ids.astype(np.int32)),
                     padding_mask=jnp.asarray(mask))
        out = model(torch.from_numpy(ids), padding_mask=torch.from_numpy(mask))
        assert out.requires_grad is False  # a frozen base carries no graph
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **TOL)
