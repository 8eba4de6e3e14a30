"""The port's MoE FFN, MoE LM and expert axis against the JAX package, on
the CPU.

`top_k_routing` is held EXACTLY equal to the reference's (dispatch and
combine, bit for bit) on the same fp32 probabilities: groups, top-1 and
top-2, capacities small enough to drop picks (Switch's order: every
k=0 pick before any k=1 pick), and padding that takes no slot. The FFN,
its aux loss and their gradients, and the MoE LM's logits and aux from
the JAX init (`transformer_lm.params_from_jax`: the router and expert
leaves cross over in the flax layout), are held to 2e-5 absolute /
1e-5 relative in fp32. Expert parallelism on gloo worlds 2 and 4 (each
rank its rows and its E/n experts, the token blocks moved by two
all-to-alls) against the port unsharded and the JAX FFN; the train step
at expert 2, at seq 2 (every row routed whole) and at model 2 x
expert 2 against the JAX step on the same sub-mesh (the tolerances of
`tests/torch_axes_ref.py`).
Also: the checkpoint tree tags equal the JAX trainer's, and pipeline +
MoE raises its ValueError.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.models import moe_lm as jm
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.ops import moe as jmoe
from hyperion_tpu_torch.models import moe_lm as tm
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.ops import moe as tmoe
from hyperion_tpu_torch.testing.ranks import run_ranks
from tests import torch_axes_ref as R
from tests import torch_parallel_workers as W

LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, ff_dim=256,
          max_len=32, dropout=0.0)
MOE = dict(n_experts=4, top_k=2, d_model=64, ff_dim=256, activation="relu")


def _probs(G, g, E, seed):
    logits = np.random.default_rng(seed).standard_normal((G, g, E)) * 2.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


ROUTING = [  # (E, top_k, capacity_factor, g, padded)
    (4, 2, 1.25, 16, False), (4, 1, 1.0, 16, False), (4, 2, 0.5, 16, False),
    (8, 2, 0.25, 32, False), (4, 2, 1.0, 16, True), (8, 3, 0.5, 24, True)]


@pytest.mark.parametrize("E,k,cf,g,padded", ROUTING)
def test_routing_is_exactly_the_reference(E, k, cf, g, padded):
    G = 3
    probs = _probs(G, g, E, seed=E * 10 + k)
    valid = None
    if padded:
        valid = (np.arange(g)[None] < np.array([g, g - 5, 3])[:, None])
        valid = valid.astype(np.float32)
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=k, capacity_factor=cf)
    tcfg = tmoe.MoEConfig(n_experts=E, top_k=k, capacity_factor=cf)
    C = jcfg.capacity(g)
    assert tcfg.capacity(g) == C
    if valid is None:
        jd, jc = jax.vmap(lambda p: jmoe.top_k_routing(p, jcfg, C))(probs)
        td, tc = tmoe.top_k_routing(torch.from_numpy(probs), tcfg, C)
    else:
        jd, jc = jax.vmap(lambda p, v: jmoe.top_k_routing(p, jcfg, C, v))(
            probs, valid)
        td, tc = tmoe.top_k_routing(torch.from_numpy(probs), tcfg, C,
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    picks = k * (g * G if valid is None else valid.sum())
    if cf < 1.0:  # the small capacities drop picks
        assert td.sum() < picks
    if padded:  # padding takes no slot and no weight
        assert float(td.numpy()[valid == 0].sum()) == 0.0


def test_switch_order_fills_top1_picks_first():
    """Capacity 1 and every token's first choice expert 0: the one slot
    goes to token 0's k=0 pick, and no k=1 pick takes a slot ahead of a
    k=0 pick, in both packages."""
    probs = np.tile(np.array([0.6, 0.3, 0.1, 0.0], np.float32), (1, 4, 1))
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.0)
    td, _ = tmoe.top_k_routing(torch.from_numpy(probs), cfg, 1)
    jd, _ = jax.vmap(lambda p: jmoe.top_k_routing(
        p, jmoe.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.0), 1))(
        probs)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[0, :, 0, 0].tolist() == [1.0, 0.0, 0.0, 0.0]
    assert td[0, :, 1, 0].tolist() == [1.0, 0.0, 0.0, 0.0]


def _layer(seed=0, E=4, d=16, f=32):
    cfg = jmoe.MoEConfig(n_experts=E, top_k=2, d_model=d, ff_dim=f,
                         activation="relu")
    params = jax.device_get(jmoe.init_moe_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    B, T = 8, 12
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    mask = (np.arange(T)[None] < rng.integers(4, T + 1, B)[:, None]
            ).astype(np.int64)
    g = rng.standard_normal((B, T, d)).astype(np.float32)
    kw = dict(n_experts=E, top_k=2, d_model=d, ff_dim=f, activation="relu")
    return cfg, kw, params, x, mask, g


def _jax_ffn(cfg, params, x, mask, g):
    def f(p, x):
        y, aux = jmoe.moe_ffn(p, x, cfg, padding_mask=mask)
        return (y * g).sum() + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    return np.asarray(y), float(aux), jax.device_get(gp), np.asarray(gx)


def test_ffn_aux_and_grads_match_jax():
    cfg, kw, params, x, mask, g = _layer()
    y, aux, gp, gx = _jax_ffn(cfg, params, x, mask, g)
    tp = {"router": {"kernel": torch.from_numpy(
        params["router"]["kernel"]).requires_grad_()},
        "experts": {k: torch.from_numpy(v).requires_grad_()
                    for k, v in params["experts"].items()}}
    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = tmoe.moe_ffn(tp, xt, tmoe.MoEConfig(**kw),
                            torch.from_numpy(mask))
    ((ty * torch.from_numpy(g)).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), y, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux), aux, rtol=1e-5)
    assert 1.0 <= aux < 4.0  # E * sum f_e P_e: 1 when balanced
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tp["router"]["kernel"].grad.numpy(),
                               gp["router"]["kernel"], atol=2e-5, rtol=1e-5)
    for k, v in gp["experts"].items():
        np.testing.assert_allclose(tp["experts"][k].grad.numpy(), v,
                                   atol=2e-5, rtol=1e-5, err_msg=k)
    # padded tokens pass through as zero
    assert np.abs(ty.detach().numpy()[mask == 0]).max() == 0.0


@pytest.fixture(scope="module")
def ep_runs():
    """The layer on worlds 2 and 4, the rows and experts split over the
    expert axis: {world: [rank results]}."""
    cfg, kw, params, x, mask, g = _layer(E=4)
    case = dict(cfg=kw, params=params, x=x, mask=mask, g=g)
    return {n: [r[0] for r in run_ranks(W.moe_ep_runs, n, [case],
                                        timeout=120)]
            for n in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_matches_unsharded_and_jax(ep_runs, world):
    cfg, kw, params, x, mask, g = _layer(E=4)
    y, aux, gp, gx = _jax_ffn(cfg, params, x, mask, g)
    ranks = ep_runs[world]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), y,
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), gx,
                               atol=2e-5, rtol=1e-5)
    for r in ranks:  # the aux loss is global over the rows
        np.testing.assert_allclose(r["aux"], aux, rtol=1e-5)
    # the router's gradient is the sum of the ranks' shares
    np.testing.assert_allclose(sum(r["drouter"] for r in ranks),
                               gp["router"]["kernel"], atol=2e-5, rtol=1e-5)
    for k, v in gp["experts"].items():
        np.testing.assert_allclose(
            np.concatenate([r["dexperts"][k] for r in ranks]), v,
            atol=2e-5, rtol=1e-5, err_msg=k)


def _jax_moe_lm(moe_every=2, **kw):
    base = jt.simple_lm_config(**{**LM, **kw})
    return jm.MoELM(jm.MoELMConfig(
        base=base, moe=jmoe.MoEConfig(**MOE), moe_every=moe_every))


@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_lm_logits_and_aux_match_jax(moe_every):
    jmodel = _jax_moe_lm(moe_every)
    params = jax.device_get(jmodel.init_params(jax.random.key(0)))
    ids, mask = R.batches(7, B=4, T=16, steps=1)[0]
    jl, jaux = jax.jit(lambda p, i, m: jmodel.apply_with_aux(
        {"params": p}, i, padding_mask=m))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    cfg = tm.MoELMConfig(tt.simple_lm_config(**LM), tmoe.MoEConfig(**MOE),
                         moe_every=moe_every)
    model = tm.MoELM(cfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, cfg.base), strict=True)
    logits, aux = model.apply_with_aux(torch.from_numpy(ids),
                                       padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    tree = tt.state_to_jax(model.state_dict(), cfg.base)
    assert jax.tree.structure(tree) == jax.tree.structure(params)


@pytest.fixture(scope="module")
def moe_step_runs():
    """The MoE LM's port runs: at expert 2 (each rank its rows and two of
    the four experts) and at seq 2 under ring attention (each rank half
    of every row's positions, the rows routed whole) on world 2, and at
    model 2 x expert 2 (the attention tensor-parallel, the experts
    whole over `model`) on world 4."""
    params = jax.device_get(_jax_moe_lm().init_params(jax.random.key(0)))
    data = R.batches(11)
    runs = [R.run((1, 1, 1, 1, 1, 2), params, data, kind="moe", cfg=LM,
                  moe=MOE, moe_every=2),
            R.run((1, 1, 1, 2, 1, 1), params, data, kind="moe",
                  cfg=dict(LM, attention_impl="ring"), moe=MOE, moe_every=2)]
    got = run_ranks(W.axes_runs, 2, runs, timeout=240)[0]
    got += run_ranks(W.axes_runs, 4, [R.run(
        (1, 1, 2, 1, 1, 2), params, data, kind="moe", cfg=LM, moe=MOE,
        moe_every=2)], timeout=240)[0]
    return params, data, dict(zip(("expert", "seq", "expert_tp"), got))


@pytest.mark.parametrize("axis,shape,impl", [
    ("expert", (1, 1, 1, 1, 1, 2), "xla"),
    ("seq", (1, 1, 1, 2, 1, 1), "ring"),
    ("expert_tp", (1, 1, 2, 1, 1, 2), "xla")])
def test_moe_train_step_matches_jax(moe_step_runs, axis, shape, impl):
    """The MoE LM's step (the aux loss added to the LM loss in both)
    against the JAX step on the same sub-mesh."""
    params, data, got = moe_step_runs
    R.assert_run_matches(got[axis], R.jax_steps(
        _jax_moe_lm(attention_impl=impl), params, data, shape, aux=True))


@pytest.mark.parametrize("pipe,experts,every", [(2, 0, 2), (1, 4, 2),
                                                (1, 4, 1), (2, 0, 1)])
def test_tree_tag_is_the_reference_s(pipe, experts, every):
    """`_pipe{S}` and `_moe{E}x{every}`, as the JAX trainer names its
    checkpoint trees (a run with another moe_every must not restore
    into this one)."""
    from hyperion_tpu.config import Config as JConfig
    from hyperion_tpu.train.trainer import _tree_tag as jax_tag
    from hyperion_tpu_torch.config import Config
    from hyperion_tpu_torch.runtime.mesh import MeshSpec, make_abstract_mesh
    from hyperion_tpu_torch.train.trainer import _tree_tag

    class Mesh:  # the JAX tag reads mesh.shape only
        shape = {"pipe": pipe}

    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.train.moe_experts, c.train.moe_every = experts, every
    mesh = make_abstract_mesh(MeshSpec(data=1, pipe=pipe))
    assert _tree_tag(mesh, cfg) == jax_tag(Mesh, jcfg)
    assert _tree_tag(None if pipe == 1 else mesh, cfg) == jax_tag(Mesh, jcfg)


def test_pipeline_with_moe_raises_the_reference_s_error():
    from hyperion_tpu_torch.config import Config
    from hyperion_tpu_torch.train.trainer import _language_model

    cfg = Config()
    cfg.train.moe_experts = 4
    with pytest.raises(ValueError, match="pipeline \\+ MoE"):
        _language_model(cfg, "language_ddp", tt.simple_lm_config(**LM),
                        {"pipe": 2}, False)


def test_expert_leaves_claim_the_expert_axis():
    """`partition_specs` on the MoE LM's flax paths is the reference's:
    `experts/` leaves lead with `expert`, the router stays replicated."""
    from flax import traverse_util

    from hyperion_tpu.parallel.partition import partition_specs as jspecs
    from hyperion_tpu_torch.parallel.partition import (
        jax_view,
        partition_specs,
    )

    jmodel = _jax_moe_lm()
    params = jax.eval_shape(jmodel.init_params, jax.random.key(0))
    mesh = R.mesh6((2, 1, 1, 1, 1, 4))
    want = traverse_util.flatten_dict(
        jspecs(params, mesh, fsdp=False), sep="/")
    model = tm.MoELM(tm.MoELMConfig(tt.simple_lm_config(**LM),
                                    tmoe.MoEConfig(**MOE)), device="meta")
    views = [jax_view(n, tuple(p.shape), 16)
             for n, p in model.named_parameters()]
    got = partition_specs({v.path: v.shape for v in views},
                          {"data": 2, "expert": 4}, fsdp=False)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == tuple(want[path]), path
    assert got["moe_block_1/experts/wi"] == ("expert",)
    assert got["moe_block_1/router"] == ()
