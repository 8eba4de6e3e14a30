"""The port's ViT, encoder and the baseline benchmark's fallback CNN
against the JAX package's, on the CPU, weights shared through each
module's `params_from_jax`.

fp32 throughout, logits within 2e-5 abs/rel (the frameworks sum the
products and softmaxes in other orders; the layers amplify that a
little). ViT is cut to image 32, patch 8, 2 layers, d 64 (the
reference's ViT-B/16 is the same code at its published widths); the
encoder to 2 layers at d 64; the CNN is size-agnostic and runs on 32 x
32 images.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.bench import baseline as jb
from hyperion_tpu.models import encoder as je
from hyperion_tpu.models import vit as jv
from hyperion_tpu_torch.bench import baseline as tb
from hyperion_tpu_torch.models import encoder as te
from hyperion_tpu_torch.models import vit as tv

TOL = dict(atol=2e-5, rtol=2e-5)
VIT = dict(image_size=32, patch_size=8, d_model=64, n_heads=4, n_layers=2,
           ff_dim=128, num_classes=10)


def _images(B=3, size=32, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("attention_impl", ["xla", "pallas"])
def test_vit_logits_match_jax(attention_impl):
    """The port's "pallas" (the flash kernel's plain version here)
    against the JAX "xla" path: the same function."""
    jmodel = jv.ViT(jv.ViTConfig(**VIT))
    params = jax.device_get(jmodel.init_params(jax.random.key(0), batch=1))
    cfg = tv.ViTConfig(**VIT, attention_impl=attention_impl)
    model = tv.ViT(cfg, device="cpu")
    model.load_state_dict(tv.params_from_jax(params, cfg))
    x = _images()
    ref = jmodel.apply({"params": params}, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    assert got.shape == (3, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_vit_b16_geometry():
    cfg = tv.vit_b16_config()
    assert (cfg.image_size, cfg.patch_size, cfg.d_model, cfg.n_layers,
            cfg.n_heads, cfg.ff_dim, cfg.num_classes) == (
        224, 16, 768, 12, 12, 3072, 1000)
    assert cfg.n_patches == 196
    assert cfg.block_cfg().causal is False
    jcfg = jv.vit_b16_config()
    for f in ("image_size", "patch_size", "d_model", "n_heads", "n_layers",
              "ff_dim", "num_classes", "dropout", "dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_vit_init_params_is_seeded_and_shaped():
    cfg = tv.ViTConfig(**VIT)
    a, b = (tv.ViT(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(4)) for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    jparams = jv.ViT(jv.ViTConfig(**VIT)).init_params(jax.random.key(0))
    want = {k: v.shape for k, v in
            tv.params_from_jax(jax.device_get(jparams), cfg).items()}
    assert {k: v.shape for k, v in a.state_dict().items()} == want
    assert (a.cls_token == 0).all()


@pytest.mark.parametrize("with_mask", [False, True])
def test_encoder_matches_jax(with_mask):
    kw = dict(d_model=64, n_heads=4, n_layers=2, ff_dim=128, dropout=0.0)
    jmodel = je.TransformerEncoder(je.custom_transformer_config(**kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(1), seq=16))
    cfg = te.custom_transformer_config(**kw)
    model = te.TransformerEncoder(cfg, device="cpu")
    model.load_state_dict(te.params_from_jax(params, cfg))
    x = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(
        np.float32)
    mask = None
    if with_mask:
        mask = np.ones((2, 16), np.int8)
        mask[1, 10:] = 0
    ref = jmodel.apply({"params": params}, jnp.asarray(x),
                       padding_mask=None if mask is None
                       else jnp.asarray(mask))
    got = model(torch.from_numpy(x),
                padding_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="d_model"):
        model(torch.zeros(1, 4, 32))


def test_custom_transformer_config_is_the_references():
    cfg, jcfg = te.custom_transformer_config(), je.custom_transformer_config()
    for f in ("d_model", "n_heads", "n_layers", "ff_dim", "activation",
              "causal", "dropout"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_ref_fallback_cnn_matches_jax():
    x = _images(B=2, size=32, seed=3)
    jmodel = jb._RefFallbackCNN(dtype="float32")
    params = jax.device_get(jmodel.init({"params": jax.random.key(0)},
                                        jnp.asarray(x))["params"])
    model = tb._RefFallbackCNN("float32", device="cpu")
    model.load_state_dict(tb.ref_cnn_params_from_jax(params))
    ref = jmodel.apply({"params": params}, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(a).size for a in jax.tree.leaves(params))
