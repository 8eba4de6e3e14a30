"""Weight-only int8 in the port against the JAX package's
`precision/quant.py`, on the CPU (the kernels' plain versions).

Bit for bit: `quantize_int8` (fp32 amax, a true division, round half to
even, clip) over the last axis, over axis 0 and over o_proj's (0, 1) in
fp32 and bf16 and with an all-zero row; `int8_matmul` (the int32 sum is
exact, the fp32 epilogue `(acc * sx) * sw` then the bias rounded to the
output dtype is the same arithmetic); `quantized_dense`; `QuantDense`
with its bias against `QuantDenseGeneral`; and the quantized weight
trees of `quantize_llama` / `quantize_lm` against the JAX ones. Whole
models: the int8 Llama's cached prefill and decode logits and the
int8 TransformerLM's logits within 2e-5 abs/rel of JAX's at fp32 (the
layers around the int8 products sum in other orders, ~1e-7 apart, which
can flip an activation's rounding to int8 now and then: 2e-5 holds
those); the temperature-0 streams equal JAX's `generate` and
`generate_recompute` exactly.
"""

from __future__ import annotations

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.models import llama as jl
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.precision import quant as jq
from hyperion_tpu_torch.infer import generate as tg
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.ops import int8_matmul as im
from hyperion_tpu_torch.precision import quant as tq

jg = importlib.import_module("hyperion_tpu.infer.generate")
TOL = dict(atol=2e-5, rtol=2e-5)
LM = dict(vocab_size=300, d_model=32, n_heads=2, n_layers=2, ff_dim=64,
          max_len=32, dropout=0.0)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor in `dtype`
    (both round fp32 to bf16 to nearest even)."""
    j = jnp.asarray(x)
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(a) -> np.ndarray:
    a = np.asarray(jnp.asarray(a).astype(jnp.float32)
                   if getattr(a, "dtype", None) == jnp.bfloat16 else a)
    return a


def _t(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, axis", [((37, 4096), -1), ((300, 64), 0),
                                         ((4, 8, 48), (0, 1))])
def test_quantize_int8_bit_exact(dtype, shape, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[1] = 0  # an all-zero row: scale max(0, 1e-8) / 127
    jx, tx = _both(x * 3, dtype)
    jqv, js = jq.quantize_int8(jx, axis=axis)
    tqv, ts = tq.quantize_int8(tx, axis)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_all_zero_row_quantizes_to_zero():
    q, s = im.quantize_rows(torch.zeros(2, 16))
    assert (q == 0).all()
    assert torch.equal(s, torch.full((2,), 1e-8) / torch.full((2,), 127.0))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M, K, N", [(1, 256, 300), (17, 100, 33),
                                     (64, 4096, 7)])
def test_int8_matmul_bit_exact(out_dtype, M, K, N):
    rng = np.random.default_rng(M + K)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)  # JAX's [K, N]
    sx = (rng.random((M, 1)) * 0.02 + 1e-4).astype(np.float32)
    sw = (rng.random((1, N)) * 0.02 + 1e-4).astype(np.float32)
    jdt = getattr(jnp, out_dtype)
    ref = jq.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx),
                         jnp.asarray(sw), jdt)
    out = tq.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
                         torch.from_numpy(sx), torch.from_numpy(sw),
                         getattr(torch, out_dtype))
    np.testing.assert_array_equal(_t(out), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_bit_exact(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 4096)).astype(np.float32)
    w = rng.standard_normal((4096, 300)).astype(np.float32)
    jwq, jsw = jq.quantize_int8(jnp.asarray(w), axis=0)
    twq, tsw = tq.quantize_int8(torch.from_numpy(w.T.copy()), -1)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(tsw[:, 0].numpy(), np.asarray(jsw)[0])
    jx, tx = _both(x, dtype)
    ref = jq.quantized_dense(jx, jwq, jsw)
    out = tq.quantized_dense(tx, twq, tsw[:, 0])
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(_t(out), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features, axis", [(48, -1), ((4, 8), -1),
                                            (24, (-2, -1))])
def test_quant_dense_with_bias_matches_quant_dense_general(dtype, features,
                                                           axis):
    """`QuantDense` (flat [out, in]) against the flax layer on the same
    int8 kernel, scale and float bias: the bias is added after the
    dequant, rounded to the output dtype first."""
    rng = np.random.default_rng(2)
    in_shape = (4, 8) if axis == (-2, -1) else (32,)
    x = rng.standard_normal((3, 5, *in_shape)).astype(np.float32)
    feats = (features,) if isinstance(features, int) else features
    w = rng.standard_normal((*in_shape, *feats)).astype(np.float32)
    nc = len(in_shape)
    kq, ks = jq.quantize_int8(jnp.asarray(w), axis=tuple(range(nc)))
    bias = rng.standard_normal(feats).astype(np.float32)
    layer = jq.QuantDenseGeneral(features=features, axis=axis,
                                 dtype=getattr(jnp, dtype), use_bias=True)
    jx, tx = _both(x, dtype)
    ref = layer.apply({"params": {"kernel_q": kq, "kernel_scale": ks,
                                  "bias": jnp.asarray(bias)}}, jx)
    k, n = int(np.prod(in_shape)), int(np.prod(feats))
    mod = tq.QuantDense(k, n, getattr(torch, dtype), "cpu", bias=True)
    mod.load_state_dict({
        "weight_q": torch.from_numpy(np.asarray(kq).reshape(k, n).T.copy()),
        "weight_scale": torch.from_numpy(np.asarray(ks).reshape(-1).copy()),
        "bias": torch.from_numpy(bias.reshape(-1))})
    out = mod(tx.reshape(3, 5, k)).reshape(3, 5, *feats)
    np.testing.assert_array_equal(_t(out.detach()), _np(ref))


# ------------------------------------------------------------ whole models


@pytest.fixture(scope="module", params=["mha", "gqa"])
def llama_pair(request):
    kw = {} if request.param == "mha" else {"n_kv_heads": 2}
    jcfg = jl.llama_tiny_config(max_len=64, **kw)
    params = jax.device_get(jl.Llama(jcfg).init_params(jax.random.key(0),
                                                        seq=8))
    jmodel, jparams = jq.quantize_llama(params, jcfg)
    cfg = tl.llama_tiny_config(max_len=64, **kw)
    model, state = tq.quantize_llama(tl.params_from_jax(params, cfg), cfg,
                                     device="cpu")
    return params, jmodel, jax.device_get(jparams), model, state


def test_quantize_llama_equals_jax_tree(llama_pair):
    params, jmodel, jparams, model, state = llama_pair
    want = tl.params_from_jax(jparams, model.cfg)
    assert set(want) == set(state)
    for k, v in want.items():
        assert torch.equal(state[k].to(v.dtype), v), k
    assert model.cfg.quant == "int8"
    assert state["layers.0.attn.o_proj.weight_q"].dtype == torch.int8
    # and back: the port's int8 model exports the JAX tree itself
    back = tl.params_to_jax(model)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))


def test_int8_llama_cached_logits_match_jax(llama_pair):
    _, jmodel, jparams, model, _ = llama_pair
    ids = np.random.default_rng(3).integers(1, 250, (2, 9)).astype(np.int32)
    jlog, jcache = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                                cache=jl.init_cache(jmodel.cfg, 2, 16),
                                cache_index=0)
    tcache = tl.init_cache(model.cfg, 2, 16, device="cpu")
    tlog, tcache = model(torch.as_tensor(ids), cache=tcache, cache_index=0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    jlog, _ = jmodel.apply({"params": jparams}, jnp.asarray(nxt),
                           cache=jcache, cache_index=9)
    tlog, _ = model(torch.as_tensor(nxt), cache=tcache, cache_index=9)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_int8_llama_stream_equals_jax_generate(llama_pair):
    _, jmodel, jparams, model, _ = llama_pair
    prompts = np.random.default_rng(4).integers(1, 250, (3, 7))
    prompts = prompts.astype(np.int32)
    jgen = jax.jit(functools.partial(jg.generate, jmodel),
                   static_argnums=(2,))
    ref = np.asarray(jgen({"params": jparams}, jnp.asarray(prompts), 16))
    out = tg.generate(model, prompts, 16, device="cpu").numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def lm_pair():
    jcfg = jt.simple_lm_config(**LM)
    params = jax.device_get(jt.TransformerLM(jcfg).init_params(
        jax.random.key(1)))
    jmodel, jparams = jq.quantize_lm(params, jcfg)
    cfg = tt.simple_lm_config(**LM)
    model, state = tq.quantize_lm(tt.params_from_jax(params, cfg), cfg,
                                  device="cpu")
    return params, jmodel, jax.device_get(jparams), model, state


def test_quantize_lm_equals_jax_tree(lm_pair):
    params, jmodel, jparams, model, state = lm_pair
    want = tt.params_from_jax(jparams, model.cfg)
    assert set(want) == set(state)
    for k, v in want.items():
        assert torch.equal(state[k].to(v.dtype), v), k
    back = tt.params_to_jax(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf),
                                      err_msg=str(path))


def test_int8_lm_logits_and_recompute_stream_match_jax(lm_pair):
    _, jmodel, jparams, model, _ = lm_pair
    ids = np.random.default_rng(5).integers(1, 300, (2, 12)).astype(np.int32)
    ref = jmodel.apply({"params": jparams}, jnp.asarray(ids))
    np.testing.assert_allclose(model(torch.as_tensor(ids)).detach().numpy(),
                               np.asarray(ref), **TOL)
    prompts = ids[:, :6]
    jgen = jax.jit(functools.partial(jg.generate_recompute, jmodel),
                   static_argnums=(2,))
    want = np.asarray(jgen({"params": jparams}, jnp.asarray(prompts), 10))
    out = tg.generate_recompute(model, prompts, 10, device="cpu").numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("which", ["llama", "lm"])
def test_dequantize_params_round_trips(llama_pair, lm_pair, which):
    """Back to float: within half a step of each row's scale of the
    float weights, equal to the JAX package's dequantized tree, and the
    other leaves untouched."""
    params, _, jparams, model, state = (llama_pair if which == "llama"
                                        else lm_pair)
    mod = tl if which == "llama" else tt
    floats = mod.params_from_jax(params, model.cfg)
    back = tq.dequantize_params(state, torch.float32)
    assert set(back) == set(floats)
    jback = mod.params_from_jax(jax.device_get(
        jq.dequantize_params(jparams, jnp.float32)), model.cfg)
    for k, v in floats.items():
        assert torch.equal(back[k], jback[k]), k
        if k + "_q" in state:
            step = state[k.removesuffix("weight") + "weight_scale"][:, None]
            assert ((back[k] - v).abs() <= step / 2 * (1 + 1e-6)).all(), k
        else:
            assert torch.equal(back[k], v), k


def test_plain_int8_path_runs_on_the_cpu():
    """An int8 model built and run on the CPU takes the plain versions
    (no launch counted) and stays finite; configs reject unknown modes
    and LoRA with int8; the MoE LM's config has no quant field and
    stays float."""
    from hyperion_tpu_torch.models.moe_lm import MoELM, MoELMConfig
    from hyperion_tpu_torch.ops.moe import MoEConfig

    before = (im.quantize_rows.launches, im.int8_matmul.launches)
    cfg = tl.llama_tiny_config(quant="int8")
    model = tl.Llama(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert isinstance(model.lm_head, tq.QuantDense)
    assert isinstance(model.layers[0].mlp.down_proj, tq.QuantDense)
    assert not isinstance(model.embed_tokens, tq.QuantDense)
    logits = model(torch.ones(1, 4, dtype=torch.long))
    assert torch.isfinite(logits).all()
    assert (im.quantize_rows.launches, im.int8_matmul.launches) == before
    with pytest.raises(ValueError, match="unknown quant mode"):
        tl.llama_tiny_config(quant="int4")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tl.llama_tiny_config(quant="int8", lora_rank=4)
    base = tt.simple_lm_config(**LM)
    moe = MoELM(MoELMConfig(base=base, moe=MoEConfig(
        n_experts=2, top_k=1, d_model=32, ff_dim=64)), device="cpu")
    assert not any(isinstance(m, tq.QuantDense) for m in moe.modules())


@pytest.mark.parametrize("bad, err", [
    (dict(xq=torch.zeros(2, 8)), TypeError),
    (dict(wq=torch.zeros(3, 9, dtype=torch.int8)), ValueError),
    (dict(sx=torch.ones(3)), ValueError),
    (dict(out_dtype=torch.float16), TypeError),
    (dict(xq=torch.zeros(0, 8, dtype=torch.int8), sx=torch.ones(0)),
     ValueError),
])
def test_int8_matmul_states_its_rule(bad, err):
    args = dict(xq=torch.zeros(2, 8, dtype=torch.int8),
                wq=torch.zeros(3, 8, dtype=torch.int8), sx=torch.ones(2),
                sw=torch.ones(3), out_dtype=torch.float32)
    args.update(bad)
    with pytest.raises(err):
        im.int8_matmul(**args)


def test_quantize_rows_takes_fp16_and_keeps_leading_dims():
    x = torch.randn(2, 3, 40, generator=torch.Generator().manual_seed(0))
    q, s = im.quantize_rows(x.half())
    q32, s32 = im.quantize_rows(x.half().float())
    assert q.shape == (2, 3, 40) and s.shape == (2, 3)
    assert torch.equal(q, q32) and torch.equal(s, s32)
