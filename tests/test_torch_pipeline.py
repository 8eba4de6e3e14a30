"""The port's pipe axis (the GPipe schedule and the PipelinedLM) against
the JAX package, on the CPU.

`parallel.pipeline.gpipe_apply` on gloo worlds 2 and 4 (each rank a
stage, `hyperion_tpu_torch/testing/ranks.py`; rank functions in
tests/torch_parallel_workers.py) at 2 and 4 microbatches, against the
same stages run in order and against the reference's `gpipe_apply` on
a pipe sub-mesh of the 8 forced host devices: output and the gradients
of the input and of every stage's weights, fp32, rtol 1e-5 / atol 1e-6.
The PipelinedLM from the JAX init (`params_from_jax` of the stacked
`stages/` leaves) against the JAX PipelinedLM's logits (2e-5), and bit
for bit against a TransformerLM with the unstacked weights; the train
step at pipe 2, pipe 2 x data 2, pipe 2 x fsdp 2 (stage leaves split
over fsdp and gathered a layer at a time inside the tick) and pipe 2 x
model 2 against the
JAX step on the same mesh (the tolerances of `tests/torch_axes_ref.py`);
the partition rules on the stacked leaves; the depth rounding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.models import pipeline_lm as jp
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.parallel.pipeline import gpipe_apply as jax_gpipe
from hyperion_tpu_torch.models import pipeline_lm as tp
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.testing.ranks import run_ranks
from tests import torch_axes_ref as R
from tests import torch_parallel_workers as W

LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=4, ff_dim=256,
          max_len=32, dropout=0.0)
B, D, L = 8, 16, 2  # batch, width, layers a stage


def _gpipe_case(S: int, micro: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed + 10 * S + micro)
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0  # rows of padding ride as an extra
    return dict(micro=micro, mask=mask,
                x=rng.standard_normal((B, D)).astype(np.float32),
                w=(rng.standard_normal((S, L, D, D)) / np.sqrt(D)
                   ).astype(np.float32),
                g=rng.standard_normal((B, D)).astype(np.float32))


GPIPE = [(2, 2), (2, 4), (4, 2), (4, 4)]  # (stages = world, microbatches)


@pytest.fixture(scope="module")
def gpipe_runs():
    out = {}
    for S in (2, 4):
        micros = [m for s, m in GPIPE if s == S]
        got = run_ranks(W.gpipe_runs, S, [_gpipe_case(S, m) for m in micros],
                        timeout=120)
        for j, m in enumerate(micros):
            out[S, m] = [r[j] for r in got]
    return out


def _sequential(c: dict):
    """The stages in order on the whole batch, with their gradients."""
    x = torch.from_numpy(c["x"]).requires_grad_()
    w = torch.from_numpy(c["w"]).requires_grad_()
    h = x
    for s in range(w.shape[0]):
        for lw in w[s]:
            h = torch.tanh(h @ lw) * torch.from_numpy(c["mask"])[:, None]
    (h * torch.from_numpy(c["g"])).sum().backward()
    return h.detach().numpy(), x.grad.numpy(), w.grad.numpy()


def _jax_gpipe(c: dict, S: int):
    mesh = R.mesh6((1, 1, 1, 1, S, 1))

    def stage(params, x_mb, m):
        for lw in params:
            x_mb = jnp.tanh(x_mb @ lw) * m[:, None]
        return x_mb

    def f(x, w):
        y = jax_gpipe(stage, w, x, mesh, n_microbatches=c["micro"],
                      extras=c["mask"])
        return (y * c["g"]).sum(), y

    (_, y), (dx, dw) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(c["x"], c["w"])
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("S,micro", GPIPE)
def test_gpipe_matches_sequential_and_jax(gpipe_runs, S, micro):
    c = _gpipe_case(S, micro)
    ranks = gpipe_runs[S, micro]
    y, dx, dw = _sequential(c)
    jy, jdx, jdw = _jax_gpipe(c, S)
    for r in ranks:  # every stage returns the last stage's output
        np.testing.assert_allclose(r["y"], y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["y"], jy, rtol=1e-5, atol=1e-6)
    # stage 0 holds the input's gradient; stage s its weights'
    np.testing.assert_allclose(ranks[0]["dx"], dx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["dx"], jdx, rtol=1e-5, atol=1e-6)
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r["dw"], dw[s], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["dw"], jdw[s], rtol=1e-5, atol=1e-6)


def test_gpipe_needs_whole_microbatches():
    from hyperion_tpu_torch.parallel.pipeline import gpipe_apply

    with pytest.raises(ValueError, match="microbatches"):
        gpipe_apply(lambda p, x, e, m: x, [], torch.zeros(6, 2), None,
                    n_microbatches=4)


@pytest.fixture(scope="module")
def pipe_case():
    jmodel = jp.PipelinedLM(jp.PipelineLMConfig(
        base=jt.simple_lm_config(**LM), n_stages=2, n_microbatches=2))
    params = jax.device_get(jmodel.init_params(jax.random.key(0)))
    return jmodel, params, R.batches(13)


def _port_model(params, stages=2, micro=2):
    cfg = tp.PipelineLMConfig(tt.simple_lm_config(**LM), stages, micro)
    model = tp.PipelinedLM(cfg, device="cpu")
    model.load_state_dict(tp.params_from_jax(params, cfg), strict=True)
    return model


def test_pipelined_lm_matches_jax_and_round_trips(pipe_case):
    jmodel, params, data = pipe_case
    ids, mask = data[0]
    want = jax.jit(lambda p, i, m: jmodel.apply({"params": p}, i,
                                                padding_mask=m))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    model = _port_model(params)
    got = model(torch.from_numpy(ids), padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    back = tp.state_to_jax(model.state_dict(), model.pipe_cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)


def test_pipelined_lm_is_the_transformer_lm_bit_for_bit():
    """From the same generator state the stacked weights are the
    TransformerLM's, and the stages in order give its logits exactly."""
    c = tt.simple_lm_config(**LM)
    pipe = tp.PipelinedLM(tp.PipelineLMConfig(c, 2, 2), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(3))
    plain = tt.TransformerLM(c, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    ids, mask = (torch.from_numpy(a) for a in R.batches(2, steps=1)[0])
    assert torch.equal(pipe(ids, padding_mask=mask),
                       plain(ids, padding_mask=mask))


@pytest.fixture(scope="module")
def pipe_runs(pipe_case):
    """The port's runs: pipe 2 on world 2; pipe 2 x data 2, pipe 2 x
    fsdp 2 and pipe 2 x model 2 (stage leaves split over `model`,
    gathered inside the tick; the embedding and head tensor-parallel) on
    world 4."""
    _, params, data = pipe_case
    kw = dict(kind="pipe", stages=2, micro=2, cfg=LM)
    got2 = run_ranks(W.axes_runs, 2, [R.run((1, 1, 1, 1, 2, 1), params,
                                            data, **kw)], timeout=240)[0]
    got4 = run_ranks(W.axes_runs, 4, [
        R.run((2, 1, 1, 1, 2, 1), params, data, **kw),
        R.run((1, 2, 1, 1, 2, 1), params, data, fsdp=True, **kw),
        R.run((1, 1, 2, 1, 2, 1), params, data, **kw)],
        timeout=240)[0]
    return {"pipe": got2[0], "pipe_data": got4[0], "pipe_fsdp": got4[1],
            "pipe_model": got4[2]}


@pytest.mark.parametrize("layout,shape,fsdp", [
    ("pipe", (1, 1, 1, 1, 2, 1), False),
    ("pipe_data", (2, 1, 1, 1, 2, 1), False),
    ("pipe_fsdp", (1, 2, 1, 1, 2, 1), True),
    ("pipe_model", (1, 1, 2, 1, 2, 1), False)])
def test_pipe_train_step_matches_jax(pipe_case, pipe_runs, layout, shape,
                                     fsdp):
    jmodel, params, data = pipe_case
    R.assert_run_matches(pipe_runs[layout], R.jax_steps(
        jmodel, params, data, shape, fsdp=fsdp))


def test_stage_leaves_claim_pipe_and_tp_shifts_past_them():
    """The port's rules on the PipelinedLM's flax paths are the
    reference's: stage leaves lead with `pipe` (the layer dim never
    fsdp's), the TP templates anchor past the two stacking dims."""
    from flax import traverse_util

    from hyperion_tpu.parallel.partition import (
        TRANSFORMER_TP_RULES as JRULES,
    )
    from hyperion_tpu.parallel.partition import partition_specs as jspecs
    from hyperion_tpu_torch.parallel.partition import (
        TRANSFORMER_TP_RULES,
        jax_view,
        partition_specs,
    )

    jmodel = jp.PipelinedLM(jp.PipelineLMConfig(
        base=jt.simple_lm_config(**LM), n_stages=2))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.key(0))
    model = tp.PipelinedLM(tp.PipelineLMConfig(tt.simple_lm_config(**LM), 2),
                           device="meta")
    views = [jax_view(n, tuple(p.shape), 16)
             for n, p in model.named_parameters()]
    for shape in ((1, 2, 2, 1, 2, 1), (2, 2, 1, 1, 2, 1)):
        want = traverse_util.flatten_dict(jspecs(
            shapes, R.mesh6(shape), tp_rules=JRULES, fsdp=True,
            fsdp_min_size=2**10), sep="/")
        got = partition_specs({v.path: v.shape for v in views},
                              dict(zip(R.AXES, shape)), TRANSFORMER_TP_RULES,
                              fsdp=True, fsdp_min_size=2**10)
        assert set(got) == set(want)
        for path, spec in got.items():
            assert spec == tuple(want[path]), (shape, path)
    assert got["stages/attn/q_proj/kernel"][0] == "pipe"


def test_depth_rounds_up_to_fill_every_stage():
    """language_ddp's 2 layers on 4 stages: 4 layers, one a stage, as
    the reference rounds them (`trainer.py:851-856`)."""
    from hyperion_tpu_torch.config import Config
    from hyperion_tpu_torch.train.trainer import _language_model

    build = _language_model(Config(), "language_ddp",
                            tt.simple_lm_config(n_layers=2), {"pipe": 4},
                            False)
    model = build("meta")
    assert (model.cfg.n_layers, model.pipe_cfg.n_stages,
            model.pipe_cfg.n_microbatches) == (4, 4, 4)
