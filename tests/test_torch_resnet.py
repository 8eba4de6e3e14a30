"""The port's ResNet (`hyperion_tpu_torch/models/resnet.py`) against the
JAX package's flax ResNet on the CPU, with the JAX init's weights
through `params_from_jax`.

Structures at narrow widths: ResNet-18 (basic blocks, CIFAR stem) at
width 8 on 16x16 images and ResNet-50 (bottleneck blocks, the ImageNet
stem with its max-pool) at width 4 on 33x33 images, so every strided
conv's "SAME" padding is asymmetric; the stem and max-pool alone also
at 17x17 and 16x16. Inputs and labels are numpy from a seed; the JAX side runs
under `jit`.

Tolerances (fp32): logits, the flax-rule running statistics after a
train-mode forward and every parameter's gradient rtol 1e-5 with atol
1e-5 of the tensor's (the leaf's) largest magnitude: a leaf's elements
share one scale, and XLA and torch sum the convolutions' terms in
different orders. The weights are the JAX init's with every BN scale
and running statistic moved off its init value (`_case`), each block's
last scale to a small one: with scales near 1 there, ResNet-50's
residual stream grows until flax's E[x^2] - E[x]^2 cancels in fp32
(|mean| >> std), and both packages' train-mode logits turn sensitive to
their summation order (7e-4 apart at 33x33, batch 8) — a property of
the formula, which the port keeps. bf16 logits:
within 2e-2 of their largest magnitude, the bound of the port's other
bf16 forwards (tests/test_torch_train.py).
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from jax import lax

from hyperion_tpu.models import resnet as jr
from hyperion_tpu.parallel import partition as jp
from hyperion_tpu.runtime.mesh import make_abstract_mesh as jax_abstract
from hyperion_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from hyperion_tpu_torch.models import resnet as tr
from hyperion_tpu_torch.parallel import partition as pp
from hyperion_tpu_torch.runtime.mesh import MeshSpec, make_abstract_mesh

CASES = {
    "resnet18": (dict(stage_sizes=(2, 2, 2, 2), bottleneck=False, width=8,
                      cifar_stem=True), 16),
    "resnet50": (dict(stage_sizes=(3, 4, 6, 3), bottleneck=True, width=4,
                      cifar_stem=False), 33),
}


def _case(name: str, dtype: str = "float32", size: int | None = None):
    kw, size0 = CASES[name]
    size = size or size0
    jmodel = jr.ResNet(jr.ResNetConfig(dtype=dtype, **kw))
    variables = jax.device_get(jmodel.init_variables(jax.random.key(0),
                                                     image_size=size))
    # every BN scale off the init's 1 and 0 (each block's last scale is
    # zero-initialised, which zeroes its branch's gradients; it gets a
    # small one, as a few steps of training give it), and running
    # statistics off 0 and 1, so every leaf carries a gradient and eval
    # mode reads real statistics
    rng = np.random.default_rng(2)
    flat = traverse_util.flatten_dict(variables)
    for k, v in flat.items():
        if k[-1] == "scale" and not v.any():
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k[-1] in ("scale", "var"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif k[-1] == "mean":
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    variables = traverse_util.unflatten_dict(flat)
    model = tr.ResNet(tr.ResNetConfig(dtype=dtype, **kw), device="cpu")
    model.load_state_dict(tr.params_from_jax(variables), strict=True)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    return jmodel, variables, model, x, y


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _flat(tree: dict) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _close(got, want, scale_rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=scale_rtol * np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_eval_logits_match(name):
    jmodel, variables, model, x, _ = _case(name)
    want = jax.jit(lambda v, i: jmodel.apply(v, i, train=False))(
        variables, x)
    got = model(_nchw(x), train=False)
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_logits_stats_and_gradients(name):
    """Train mode: the batch statistics normalise, the running ones
    move by flax's rule (momentum 0.9, the biased variance), and every
    leaf's gradient of the mean CE equals JAX's."""
    jmodel, variables, model, x, y = _case(name)

    def loss(params):
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean(), (logits, mut["batch_stats"])

    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    out = model(_nchw(x), train=True)
    torch.nn.functional.cross_entropy(out, torch.from_numpy(y).long()
                                      ).backward()
    _close(out.detach().numpy(), logits)
    got = tr.state_to_jax({**{n: p.grad for n, p in model.named_parameters()},
                           **dict(model.named_buffers())})
    want_g, got_g = _flat(jax.device_get(grads)), _flat(got["params"])
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        _close(got_g[k], w)
    want_s, got_s = _flat(jax.device_get(stats)), _flat(got["batch_stats"])
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        _close(got_s[k], w)


def test_float64_model_runs_in_float64():
    """`dtype="float64"` and `.double()`: statistics, logits and
    gradients in float64 (the reference the card's gradients are held
    to), equal to the fp32 model's within the fp32 bound."""
    _, variables, model, x, y = _case("resnet18")
    model64 = tr.ResNet(tr.ResNetConfig(dtype="float64", **CASES[
        "resnet18"][0]), device="cpu")
    model64.load_state_dict(model.state_dict())
    model64.double()
    grads = {}
    for m, dt in ((model, torch.float32), (model64, torch.float64)):
        out = m(_nchw(x).to(dt), train=True)
        assert out.dtype == dt
        torch.nn.functional.cross_entropy(out, torch.from_numpy(y).long()
                                          ).backward()
        grads[dt] = {n: p.grad for n, p in m.named_parameters()}
    assert model64.stem_bn.running_var.dtype == torch.float64
    for n, g in grads[torch.float64].items():
        assert g.dtype == torch.float64
        _close(grads[torch.float32][n].numpy(), g.numpy())


def test_bf16_forward_within_the_bf16_bound():
    """bf16 compute (fp32 params and statistics): the eval and train
    logits against JAX's bf16 model."""
    jmodel, variables, model, x, _ = _case("resnet18", "bfloat16")
    for train in (False, True):
        want = np.asarray(jax.jit(lambda v, i: jmodel.apply(
            v, i, train=train, mutable=["batch_stats"])[0])(variables, x))
        got = model(_nchw(x), train=train).detach().numpy()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("size", [7, 8, 16, 17, 32, 224])
@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (7, 2), (1, 2)])
def test_same_pads_are_lax_s(size, k, stride):
    """flax "SAME" padding: odd pixel at the end under a stride (3x3/s2
    on 32 pads 0/1, 7x7/s2 on 224 pads 2/3, 1x1/s2 nothing)."""
    want = lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert tr.same_pads(size, k, stride) == tuple(want)


@pytest.mark.parametrize("size, out", [(17, 5), (16, 4)])
def test_imagenet_stem_and_max_pool_match(size, out):
    """The 7x7/s2 stem conv, its BN and the -inf-padded 3x3/s2
    max-pool, alone, at an odd and an even size: the stem's output
    feeds every later layer, so a one-pixel shift would show here
    first."""
    jmodel, variables, model, x, _ = _case("resnet50", size=size)
    stem = {"params": {k: variables["params"][k]
                       for k in ("stem_conv", "stem_bn")},
            "batch_stats": {"stem_bn": variables["batch_stats"]["stem_bn"]}}

    class Stem(jr.nn.Module):
        @jr.nn.compact
        def __call__(self, img):
            h = jr._conv(4, 7, 2, "stem_conv")(img)
            h = jr.nn.relu(jr._bn(False, "stem_bn")(h))
            return jr.nn.max_pool(h, (3, 3), strides=(2, 2), padding="SAME")

    want = np.asarray(Stem().apply(stem, x)).transpose(0, 3, 1, 2)
    h = torch.relu(model.stem_bn(model.stem_conv(_nchw(x)), False))
    got = torch.nn.functional.max_pool2d(
        tr._pad_same(h, 3, 2, float("-inf")), 3, 2)
    assert got.shape == want.shape == (8, 4, out, out)
    _close(got.detach().numpy(), want)


def test_published_widths_and_init():
    """ResNet-18 at its published widths: 11,173,962 parameters as the
    JAX tree holds, the flax paths and shapes leaf for leaf; the init's
    zero last-BN scale in every block and its fan-out conv scale."""
    jshapes = jax.eval_shape(lambda r: jr.resnet18().init_variables(r),
                             jax.random.key(0))
    model = tr.resnet18(device="cpu").init_params(
        torch.Generator().manual_seed(0))
    got = tr.state_to_jax(model.state_dict())
    for section in ("params", "batch_stats"):
        want = {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(
            jshapes[section], sep="/").items()}
        assert {k: v.shape for k, v in _flat(got[section]).items()} == want
    assert sum(p.numel() for p in model.parameters()) == 11_173_962
    for block in model.blocks:
        assert torch.all(block.bn2.weight == 0) and torch.all(
            block.bn1.weight == 1)
    w = model.stage3_block0.conv1.weight  # [512, 256, 3, 3]
    assert abs(float(w.detach().std()) - (2.0 / (9 * 512)) ** 0.5) < 1e-3


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 4, 1), (2, 2, 1)])
def test_partition_specs_equal_the_jax_rules(shape):
    """`jax_view` reads a conv weight [O, I, kh, kw] as the flax kernel
    [kh, kw, I, O] and a BN weight as its `scale`: the FSDP sweep picks
    the JAX package's dim for every ResNet-18 leaf."""
    jparams = jax.eval_shape(lambda r: jr.resnet18().init_variables(r),
                             jax.random.key(0))["params"]
    want = {k: tuple(v) for k, v in traverse_util.flatten_dict(
        jp.partition_specs(jparams, jax_abstract(JaxMeshSpec(*shape)),
                           fsdp=True), sep="/").items()}
    model = tr.resnet18(device="meta")
    views = {n: pp.jax_view(n, tuple(p.shape), 1)
             for n, p in model.named_parameters()}
    got = pp.partition_specs({v.path: v.shape for v in views.values()},
                             make_abstract_mesh(MeshSpec(*shape)))
    assert got == want
    lay = pp.model_layouts(model, make_abstract_mesh(MeshSpec(*shape)))
    # a conv kernel's fsdp dim is flax's O, torch's dim 0
    assert lay["stage3_block0.conv2.weight"].fsdp == 0
