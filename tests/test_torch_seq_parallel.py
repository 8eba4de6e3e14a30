"""The port's seq axis (ring and Ulysses attention) and Llama's tensor
parallelism against the JAX package, on the CPU.

Ring and Ulysses attention: the same [B, T, H, D] fp32 q, k, v and a
ragged padding mask, sharded over seq on gloo worlds 2 and 4
(`hyperion_tpu_torch/testing/ranks.py`, rank functions in
tests/torch_parallel_workers.py) and over a seq sub-mesh of the 8
forced host devices for JAX (`ring_attention` / `ulysses_attention`):
outputs and the gradients of sum(out * do) w.r.t. q, k and v, causal
and not, held to 2e-5 absolute (the reference's own fp32 bound between
its flash kernel and the dense path). Train steps: the language
trainer's layout and loss (`tests/torch_axes_ref.py`, the tolerances of
tests/test_torch_parallel_train.py: losses and grad norms rtol 1e-5)
at seq 2 under ring and Ulysses for the TransformerLM, and the tiny fp32 Llama at model 2
(tensor parallelism, its embedding split over its d columns) and at
seq 2 (RoPE at global positions), against the JAX step on the same
mesh. Dropout is off.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from hyperion_tpu.models import llama as jl
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.ops.ring_attention import ring_attention
from hyperion_tpu.ops.ulysses import ulysses_attention
from hyperion_tpu_torch.testing.ranks import run_ranks
from tests import torch_axes_ref as R
from tests import torch_parallel_workers as W

LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, ff_dim=256,
          max_len=32, dropout=0.0)
ATOL = 2e-5
B, T, H, D = 2, 16, 4, 8


def _attn_case(impl: str, causal: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    pad = np.ones((B, T), np.int64)
    pad[0, 11:] = 0  # ragged right padding
    pad[1, 5:] = 0
    return dict(impl=impl, causal=causal, q=q, k=k, v=v, do=do, pad=pad)


CASES = [(impl, causal) for impl in ("ring", "ulysses")
         for causal in (True, False)]


@pytest.fixture(scope="module")
def attention_runs():
    """Every case on worlds 2 and 4: {(world, impl, causal): [rank
    results]}."""
    cases = [_attn_case(i, c) for i, c in CASES]
    out = {}
    for world in (2, 4):
        got = run_ranks(W.seq_attention_runs, world, cases, timeout=120)
        for j, (impl, causal) in enumerate(CASES):
            out[world, impl, causal] = [r[j] for r in got]
    return out


def _jax_attention(case: dict, world: int):
    mesh = R.mesh6((1, 1, 1, world, 1, 1))
    fn = ring_attention if case["impl"] == "ring" else ulysses_attention

    def f(q, k, v):
        o = fn(q, k, v, mesh, causal=case["causal"],
               padding_mask=case["pad"].astype(np.int32))
        return (o * case["do"]).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(case["q"], case["k"], case["v"])
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl,causal", CASES)
def test_attention_and_grads_match_jax(attention_runs, world, impl, causal):
    case = _attn_case(impl, causal)
    o, (dq, dk, dv) = _jax_attention(case, world)
    ranks = attention_runs[world, impl, causal]
    for name, want in (("out", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        got = np.concatenate([r[name] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)


def test_ulysses_caps_parallelism_at_the_head_count():
    """H % n raises, as the reference's does (3 heads over 2 ranks; the
    check comes before any collective)."""
    from unittest import mock

    import torch

    from hyperion_tpu_torch.ops import ulysses

    x = torch.zeros(1, 4, 3, 8)
    with mock.patch.object(ulysses, "group_size", return_value=2), \
            pytest.raises(ValueError, match="capped by heads"):
        ulysses.ulysses_attention(x, x, x, None)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_impls_need_an_active_mesh(impl):
    """Without a mesh the dispatch raises JAX's error, never a quiet
    fallback to the dense attention."""
    import torch

    from hyperion_tpu_torch.ops.attention import dot_product_attention
    from hyperion_tpu_torch.runtime.mesh import activate_mesh

    x = torch.zeros(1, 4, 2, 8)
    with activate_mesh(None), pytest.raises(ValueError,
                                            match="needs an active mesh"):
        dot_product_attention(x, x, x, impl=impl)


# --- train steps -----------------------------------------------------


@pytest.fixture(scope="module")
def lm_case():
    model = jt.TransformerLM(jt.simple_lm_config(**LM))
    params = jax.device_get(model.init_params(jax.random.key(0)))
    return model, params, R.batches(3)


@pytest.fixture(scope="module")
def llama_case():
    cfg = jl.llama_tiny_config(dtype="float32")
    model = jl.Llama(cfg)
    params = jax.device_get(model.init_params(jax.random.key(0), seq=32))
    return cfg, params, R.batches(5)


@pytest.fixture(scope="module")
def port_runs(lm_case, llama_case):
    """The port's world-2 runs: the LM at seq 2 under ring and Ulysses,
    the Llama at model 2 and at seq 2 (ring)."""
    _, params, data = lm_case
    _, lparams, ldata = llama_case
    runs = [R.run((1, 1, 1, 2, 1, 1), params, data,
                  cfg=dict(LM, attention_impl=impl))
            for impl in ("ring", "ulysses")]
    runs += [R.run(shape, lparams, ldata, kind="llama",
                   cfg=dict(dtype="float32", **extra))
             for shape, extra in (((1, 1, 2, 1, 1, 1), {}),
                                  ((1, 1, 1, 2, 1, 1),
                                   {"attention_impl": "ring"}))]
    got = run_ranks(W.axes_runs, 2, runs, timeout=240)[0]
    return dict(zip(("ring", "ulysses", "llama_tp", "llama_seq"), got))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq2_train_step_matches_jax(lm_case, port_runs, impl):
    """Each row's positions split over 2 ranks: the port's losses, grad
    norms and final parameters are the JAX step's on a seq-2 mesh with
    the same attention impl."""
    model, params, data = lm_case
    jmodel = jt.TransformerLM(jt.simple_lm_config(**LM, attention_impl=impl))
    R.assert_run_matches(port_runs[impl], R.jax_steps(
        jmodel, params, data, (1, 1, 1, 2, 1, 1)))


def test_llama_tensor_parallel_train_step_matches_jax(llama_case,
                                                      port_runs):
    """Llama at model 2: q/k/v/up/gate column-parallel, o/down
    row-parallel, lm_head and the embedding (a root parameter, split
    over its d columns as the reference's `embed_tokens/embedding ->
    P(None, model)`) gathered."""
    cfg, params, data = llama_case
    R.assert_run_matches(port_runs["llama_tp"], R.jax_steps(
        jl.Llama(cfg), params, data, (1, 1, 2, 1, 1, 1)))


def test_llama_seq2_train_step_matches_jax(llama_case, port_runs):
    """Llama's RoPE at global positions under a seq-2 ring."""
    cfg, params, data = llama_case
    jcfg = jl.llama_tiny_config(dtype="float32", attention_impl="ring")
    R.assert_run_matches(port_runs["llama_seq"], R.jax_steps(
        jl.Llama(jcfg), params, data, (1, 1, 1, 2, 1, 1)))


def test_llama_tp_keeps_its_parameter_names():
    """The split embedding stays the root parameter `embed_tokens`, so
    `params_from_jax`, the `.npz` names and earlier checkpoints load
    unchanged."""
    import torch

    from hyperion_tpu_torch.models import llama as ll

    cfg = ll.llama_tiny_config(dtype="float32")
    model = ll.Llama(cfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "embed_tokens" in names
    sd = ll.params_from_jax(jax.device_get(jl.Llama(
        jl.llama_tiny_config()).init_params(jax.random.key(0), seq=16)),
        cfg)
    assert set(sd) == names
    ids = torch.tensor([[3, 4, 5]])
    assert torch.equal(ll.embed_lookup(model.embed_tokens, ids),
                       model.embed_tokens[ids])


def test_seq_axis_refuses_a_dense_attention():
    """Under a seq axis the dense impls would attend within one shard:
    the model raises instead of training on the wrong attention."""
    import torch

    from hyperion_tpu_torch.models import transformer_lm as tt
    from hyperion_tpu_torch.runtime import mesh as mesh_mod

    model = tt.TransformerLM(tt.simple_lm_config(**LM), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_mod, "seq_shard", lambda: (0, 2))
        with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
            model(torch.zeros(1, 8, dtype=torch.long))


@pytest.mark.parametrize("axis", ["seq", "pipe", "expert"])
def test_an_axis_without_its_ranks_raises(axis, tmp_path):
    """No fallback: an axis > 1 in a single process (no process group)
    raises before anything trains, never runs unsharded."""
    from hyperion_tpu_torch.config import Config
    from hyperion_tpu_torch.train.trainer import train_language_model

    cfg = Config()
    cfg.train.base_dir = str(tmp_path)
    setattr(cfg.distributed, axis, 2)
    with pytest.raises(ValueError, match="1 devices not divisible"):
        train_language_model(cfg, device="cpu")
