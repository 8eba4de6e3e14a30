"""Flash attention past head_dim 256, against the JAX package on the CPU.

The reference's kernels tile the whole D, so they take any head_dim; the
port runs D past 256 on the wide kernels (`csrc/flash_attention_wide.cu`)
at the tensors' own width. Their plain versions, which the CPU runs, are
held here to the JAX kernel and its `jax.grad` in interpret mode at
[1, 256, 2, D], D 264, 320 and 512, causal with a ragged key padding and
full, with blocks of 128 queries and 64 keys, so the JAX side's online
softmax crosses tiles. fp32, within the reference's bounds (o and lse
2e-5, gradients 2e-4) times (D / 128)^1.5, the growth of an fp32 dot
product's error bound with D at logits scaled by 1/sqrt(D)
(chip_smoke.fp32_flash_growth).

The slice as a whole: a TransformerLM at head_dim 320 (d_model 320, one
head) with `attention_impl="pallas"`, weights crossed by
`params_from_jax`: the loss and every gradient leaf against the JAX
model's, at the tolerances of the D 256 model test
(tests/test_torch_surfaces.py).

Inputs come from numpy seeds; the JAX side runs jitted, one program a
case, since the interpreter is traced op by op eagerly. Slowest
(`--durations`, one CPU process): the model, ~5 s; each kernel case
~1.5-3 s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.ops.pallas.flash_attention import _flash_forward
from hyperion_tpu.ops.pallas.flash_attention import flash_attention as jflash
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.ops import flash_attention as fa

BLOCKS = dict(block_q=128, block_kv=64)
SHAPE = (1, 256, 2)


def _growth(D: int) -> float:
    return max(1.0, (D / 128) ** 1.5)


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((*SHAPE, D)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones(SHAPE[:2], np.int8)
    mask[0, int(rng.integers(SHAPE[1] // 2, SHAPE[1])):] = 0
    return q, k, v, g, mask


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [264, 320, 512])
def test_plain_versions_match_jax_past_256(D, causal):
    """Forward (o, lse) and backward (dq, dk, dv) of the plain versions,
    as the CPU wrappers and the autograd Function run them, against the
    JAX kernels; the wrappers take D as it is (no padded copy)."""
    assert fa.kernel_head_dim(D, torch.float32) == D
    assert not fa.host_padded(D, torch.float32)
    q, k, v, g, mask = _inputs(D, seed=D + causal)
    # causal with the ragged padding; full without a mask
    jm = jnp.asarray(mask) if causal else None
    tm = torch.from_numpy(mask) if causal else None
    def jloss(q, k, v):
        o = jflash(q, k, v, causal=causal, padding_mask=jm, **BLOCKS)
        return jnp.sum(o * jnp.asarray(g)), o

    def jref(q, k, v):  # one jitted program: the interpreter traces once
        lse = _flash_forward(q, k, v, jm, causal, BLOCKS["block_q"],
                             BLOCKS["block_kv"])[1]
        return jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                  has_aux=True)(q, k, v), lse

    ((_, ref_o), ref_grads), ref_lse = jax.jit(jref)(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=causal, padding_mask=tm)
    o.backward(torch.from_numpy(g))
    _, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, padding_mask=tm)
    tol = 2e-5 * _growth(D)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=tol, rtol=tol)
    for t, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=10 * tol, rtol=10 * tol)


def test_lm_at_head_dim_320_loss_and_grads_match_jax():
    """d_model 320, one head: the flash path at D 320 through the model's
    attention, fp32, dropout off, gelu (as the D 256 model test, whose
    reasons hold here); the loss is the mean next-token cross-entropy
    over the unpadded positions, in each framework's own ops."""
    kw = dict(vocab_size=1000, d_model=320, n_heads=1, n_layers=2,
              ff_dim=320, max_len=16, dropout=0.0, activation="gelu",
              attention_impl="pallas")
    jmodel = jt.TransformerLM(jt.simple_lm_config(**kw))
    # jitted: eager flax dispatches (and the interpreted kernel's trace)
    # op by op
    params = jax.device_get(jax.jit(jmodel.init_params)(jax.random.key(1)))
    cfg = tt.simple_lm_config(**kw)
    assert cfg.head_dim == 320
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, cfg))
    rng = np.random.default_rng(22)
    ids = rng.integers(0, 1000, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int8)
    mask[1, 11:] = 0
    keep = mask[:, 1:].astype(np.float32)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                              padding_mask=jnp.asarray(mask))
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.asarray(ids[:, 1:, None]),
                                   axis=-1)[..., 0]
        return jnp.sum(nll * keep) / keep.sum()

    ref, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    logits = model(torch.from_numpy(ids), padding_mask=torch.from_numpy(mask))
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -lp.gather(-1, torch.from_numpy(ids[:, 1:, None]).long())[..., 0]
    loss = (nll * torch.from_numpy(keep)).sum() / float(keep.sum())
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    loss.backward()
    grads = tt.state_to_jax({n: p.grad for n, p in model.named_parameters()},
                            cfg)
    leaves = list(zip(jax.tree_util.tree_leaves_with_path(grads),
                      jax.tree_util.tree_leaves_with_path(
                          jax.device_get(ref_grads))))
    largest = max(np.abs(np.asarray(r)).max() for _, (_, r) in leaves)
    for (path, gr), (_, r) in leaves:
        if "k_proj" in str(path) and "bias" in str(path):
            # k_proj's bias adds one constant to every logit of a row,
            # which the softmax cancels: its gradient is zero in exact
            # arithmetic, and each side's is rounding noise
            assert np.abs(gr).max() <= 1e-6 * largest, path
            continue
        assert np.abs(gr - np.asarray(r)).max() <= \
            1e-4 * np.abs(np.asarray(r)).max(), path
