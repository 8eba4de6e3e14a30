"""The port's next-token loss over the whole [B, T, V] logits against the
JAX package's, on the CPU.

`next_token_loss(impl="pallas")` hands the model's whole logits to
`fused_softmax_xent_shifted`, whose gradient is that of the whole
[B, T, V] tensor (the last position zero). The JAX side runs
`hyperion_tpu/train/losses.py`'s `next_token_loss` with its Pallas
cross-entropy in interpret mode, as tests/test_pallas_kernels.py runs
it; the port's wrappers run their plain versions on CPU tensors. The
inputs are made with numpy from a seed and handed to both.

Tolerances: the loss 1e-5 relative; the gradient with respect to the
logits 1e-5 relative and 1e-12 absolute (at g ~ 1/rows most elements
lie far below any useful absolute bound), as the kernel tests hold
dlogits; the last position's gradient exactly zero. The CUDA kernels
are held to the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.train.losses import next_token_loss as jax_next_token_loss
from hyperion_tpu_torch.ops import fused_ce as ce_mod
from hyperion_tpu_torch.ops.fused_ce import (
    fused_softmax_xent_bwd,
    fused_softmax_xent_fwd,
    fused_softmax_xent_plain,
    fused_softmax_xent_shifted,
)
from hyperion_tpu_torch.train.losses import next_token_loss

# (B, T, V): a vocab that is a multiple of 4, and an odd one
SHAPES = {"2x9x300": (2, 9, 300), "2x9x1001": (2, 9, 1001)}


def _inputs(B, T, V, seed):
    """fp32 logits, int32 ids and a right-padded mask (row 0 ends three
    tokens early, so padded targets carry no weight)."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, T, V))).astype(np.float32)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, T - 3:] = 0
    return logits, ids, mask


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_loss_and_full_gradient_match_jax(shape, masked, impl):
    logits, ids, mask = _inputs(*SHAPES[shape], seed=51)
    m = mask if masked else None

    def jloss(x):
        return jax_next_token_loss(x, jnp.asarray(ids),
                                   None if m is None else jnp.asarray(m),
                                   impl=impl)

    ref_loss, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    leaf = torch.from_numpy(logits).requires_grad_()
    loss = next_token_loss(leaf, torch.from_numpy(ids),
                           None if m is None else torch.from_numpy(m),
                           impl=impl)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert leaf.grad.shape == leaf.shape
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-12, rtol=1e-5)
    assert not leaf.grad[:, -1].any()  # the last position scores nothing
    if masked:  # padded targets carry no weight: their rows are zero too
        assert not leaf.grad[0, -4:].any() and leaf.grad[0, -5].any()


class TestShiftedEntry:
    def test_cpu_is_the_plain_version_on_the_view(self):
        logits, ids, _ = _inputs(*SHAPES["2x9x1001"], seed=52)
        lt, targets = torch.from_numpy(logits), torch.from_numpy(ids)[:, 1:]
        before = (fused_softmax_xent_fwd.launches,
                  fused_softmax_xent_bwd.launches)
        leaf = lt.clone().requires_grad_()
        out = fused_softmax_xent_shifted(leaf, targets)
        assert torch.equal(out, fused_softmax_xent_plain(lt[:, :-1], targets))
        g = torch.from_numpy(np.random.default_rng(53).random(
            tuple(targets.shape)).astype(np.float32))
        out.backward(g)
        ref = lt.clone().requires_grad_()
        fused_softmax_xent_plain(ref[:, :-1], targets).backward(g)
        assert torch.equal(leaf.grad, ref.grad)
        assert (fused_softmax_xent_fwd.launches,
                fused_softmax_xent_bwd.launches) == before

    @pytest.mark.parametrize("logits_shape, targets_shape", [
        ((2, 9, 30), (2, 9)),      # targets not one shorter
        ((18, 30), (17,)),         # [N, V] logits
        ((2, 9, 30), (2, 8, 1)),
    ])
    def test_rejects_shapes_it_does_not_score(self, logits_shape,
                                              targets_shape):
        with pytest.raises(ValueError, match=r"\[B, T, V\]"):
            fused_softmax_xent_shifted(
                torch.zeros(logits_shape),
                torch.zeros(targets_shape, dtype=torch.int64))

    def test_one_position_scores_nothing(self):
        leaf = torch.randn(3, 1, 20, requires_grad=True)
        out = fused_softmax_xent_shifted(
            leaf, torch.zeros(3, 0, dtype=torch.int64))
        assert out.shape == (3, 0)
        out.sum().backward()
        assert leaf.grad is None or not leaf.grad.any()


class TestDestination:
    """What the backward kernel's wrapper decides on the host: where the
    gradient lies against the 16-byte grid, and which destinations it
    refuses before any launch."""

    @pytest.mark.parametrize("skew", [0, 1, 2, 3])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    def test_gradient_sits_on_the_grid_as_the_logits_do(self, skew, dtype):
        buf = torch.empty(4 * 7 * 33 + 8, dtype=dtype)
        logits = buf[skew:skew + 4 * 7 * 33].view(4, 7, 33)
        d = ce_mod._like_on_grid(logits, logits.shape)
        assert d.shape == logits.shape and d.is_contiguous()
        assert d.dtype == dtype
        assert d.data_ptr() % 16 == logits.data_ptr() % 16

    @pytest.mark.parametrize("bad", ["fewer_rows", "vocab", "dtype",
                                     "batch", "vocab_stride"])
    def test_refuses_a_destination_that_cannot_take_the_gradient(self, bad):
        logits = torch.zeros(2, 5, 10)
        view = logits[:, :-1]
        t32 = torch.zeros(2, 4, dtype=torch.int32)
        lse, g = torch.zeros(2, 4), torch.ones(2, 4)
        dst = {"fewer_rows": torch.empty(2, 3, 10),
               "vocab": torch.empty(2, 5, 11),
               "dtype": torch.empty(2, 5, 10, dtype=torch.bfloat16),
               "batch": torch.empty(3, 5, 10),
               "vocab_stride": torch.empty(2, 10, 5).transpose(1, 2)}[bad]
        with pytest.raises(ValueError, match="cannot take the gradient"):
            ce_mod._run_bwd_into(view, t32, lse, g, dst)
