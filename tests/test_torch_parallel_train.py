"""The port's data, fsdp and model axes against the JAX package's train
step on the same mesh shape, on the CPU.

The JAX side runs on sub-meshes of the 8 forced host devices
(tests/conftest.py); the port runs gloo worlds of the same size
(`hyperion_tpu_torch/testing/ranks.py`, one spawned process a rank, the
rank functions in tests/torch_parallel_workers.py). Weights come from
the JAX init through `params_from_jax`; batches are numpy from a seed,
ragged right padding on every row; dropout is off; fp32 with the plain
attention and norms ("xla": both packages' CPU paths).

Tolerances: per-step losses and grad norms rtol 1e-5; final parameters
rtol 1e-5, atol 1e-6 after 3 AdamW steps at the language_fsdp job's
learning rate, 1e-4 — except each attention's k_proj bias, whose
gradient is zero in exact arithmetic (softmax is unchanged by a
constant added to every key's score), so AdamW, which divides each
element's gradient by its own magnitude, moves it by the sign of
rounding noise in either package: it is held to AdamW's bound, lr per
step. (The same normalisation moves an element whose gradient is a
rounding error away from zero, a dead ReLU unit's, by up to lr: at lr
1e-3 one such element of 16384 in an fc2 kernel differed by 9.5e-6.)
The bf16 tiny Llama's losses agree within one bf16 ulp at the loss's
scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hyperion_tpu.models import llama as jl
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.parallel.partition import TRANSFORMER_TP_RULES
from hyperion_tpu.runtime.mesh import MeshSpec, batch_sharding, make_mesh
from hyperion_tpu.train.losses import next_token_loss as jax_loss
from hyperion_tpu.train.state import create_train_state
from hyperion_tpu.train.state import make_optimizer as jax_optimizer
from hyperion_tpu.train.step import make_train_step as jax_train_step
from hyperion_tpu_torch.testing.ranks import run_ranks
from tests import torch_parallel_workers as W

LM = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, ff_dim=256,
          max_len=32, dropout=0.0)
LLAMA = dict(dtype="bfloat16")
# the language_fsdp job's learning rate (the reference's LM-FSDP 1e-4);
# a clip threshold below every step's norm here, so every update clips
LR, CLIP, WD = 1e-4, 0.5, 0.01
STEPS, B, T = 3, 8, 32


def _batches(seed: int, vocab: int = 256, ragged: bool = False):
    """STEPS global batches: ids [B, T] and right-padded masks. With
    `ragged`, the first half of the rows (the first data shard's at
    world 2) is mostly padding and the rest is whole."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, (B, T)).astype(np.int64)
        lens = rng.integers(T // 2, T + 1, B)
        if ragged:
            lens[:B // 2] = rng.integers(3, 6, B // 2)
            lens[B // 2:] = T
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
        out.append((ids, mask))
    return out


def _jax_params(model, seed: int = 0):
    return jax.device_get(model.init_params(jax.random.key(seed)))


def _jax_steps(model, params, batches, shape, fsdp: bool, policy="fp32"):
    """The JAX package's sharded train step on a (data, fsdp, model)
    sub-mesh: per-step losses and grad norms, and the final params."""
    d, f, m = shape
    mesh = make_mesh(MeshSpec(data=d, fsdp=f, model=m),
                     devices=jax.devices()[:d * f * m])
    opt = jax_optimizer(LR, weight_decay=WD, grad_clip_norm=CLIP)
    state, sharding = create_train_state(
        lambda r: {"params": jax.tree.map(jnp.asarray, params)}, opt, mesh,
        jax.random.key(0), policy=policy, tp_rules=TRANSFORMER_TP_RULES,
        fsdp=fsdp)

    def loss_fn(p, bs, batch, rngs):
        logits = model.apply({"params": p}, batch["input_ids"],
                             padding_mask=batch["attention_mask"])
        loss = jax_loss(logits, batch["input_ids"], batch["attention_mask"])
        return loss, ({"loss": loss}, bs)

    step = jax_train_step(loss_fn, opt, sharding, donate=False)
    losses, norms = [], []
    for ids, mask in batches:
        batch = {k: jax.device_put(v.astype(np.int32), batch_sharding(mesh))
                 for k, v in (("input_ids", ids), ("attention_mask", mask))}
        state, m = step(state, batch, jax.random.key(1))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.device_get(state.params)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v, np.float32)


def _assert_params_close(got: dict, want: dict):
    want = dict(_flat(want))
    got = dict(_flat(got))
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("k_proj/bias"):
            assert np.abs(got[k] - w).max() <= 2 * STEPS * LR, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _lm_run(shape, fsdp, params, batches):
    return dict(mesh=shape, fsdp=fsdp, cfg=LM, params=params,
                batches=batches, lr=LR, clip=CLIP, wd=WD)


# (mesh, fsdp) per layout, grouped by world: one spawned world runs all
# of its layouts in turn
WORLD2 = {"ddp": ((2, 1, 1), False), "fsdp": ((1, 2, 1), True),
          "tp": ((1, 1, 2), False)}
WORLD4 = {"fsdp_tp": ((1, 2, 2), True), "hsdp": ((2, 2, 1), True)}


@pytest.fixture(scope="module")
def lm_case():
    """The JAX model, its weights, the batches (ragged padding on every
    row), and the port's results of every layout."""
    model = jt.TransformerLM(jt.simple_lm_config(**LM))
    params = _jax_params(model)
    batches = _batches(3)
    ragged = _batches(4, ragged=True)
    runs2 = [_lm_run(s, f, params, batches) for s, f in WORLD2.values()]
    runs2.append(_lm_run((2, 1, 1), False, params, ragged))
    got2 = run_ranks(W.lm_runs, 2, runs2, timeout=180)[0]
    got4 = run_ranks(W.lm_runs, 4, [_lm_run(s, f, params, batches)
                                    for s, f in WORLD4.values()],
                     timeout=180)[0]
    got = dict(zip([*WORLD2, "ragged"], got2)) | dict(zip(WORLD4, got4))
    return model, params, batches, ragged, got


@pytest.mark.parametrize("layout", [*WORLD2, *WORLD4])
def test_layout_matches_the_jax_step_on_the_same_mesh(lm_case, layout):
    model, params, batches, _, got = lm_case
    shape, fsdp = {**WORLD2, **WORLD4}[layout]
    losses, norms, final = _jax_steps(model, params, batches, shape, fsdp)
    np.testing.assert_allclose(got[layout]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got[layout]["norms"], norms, rtol=1e-5)
    _assert_params_close(got[layout]["params"], final)


def test_ragged_padding_is_a_global_mean(lm_case):
    """Rank 0's rows are mostly padding, rank 1's whole: the loss is
    the mean over every real token of the global batch (the JAX loss),
    which a mean of the ranks' means misses by far more than the
    tolerance."""
    model, params, _, ragged, got = lm_case
    losses, norms, final = _jax_steps(model, params, ragged, (2, 1, 1),
                                      False)
    np.testing.assert_allclose(got["ragged"]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["ragged"]["norms"], norms, rtol=1e-5)
    _assert_params_close(got["ragged"]["params"], final)
    # the mean of per-rank means on the first batch, from the JAX model
    ids, mask = ragged[0]
    logits = model.apply({"params": params}, ids.astype(np.int32),
                         padding_mask=mask.astype(np.int32))
    halves = [float(jax_loss(logits[s], ids[s], mask[s]))
              for s in (slice(0, B // 2), slice(B // 2, B))]
    assert abs(np.mean(halves) - losses[0]) > 100 * 1e-5 * losses[0]


def test_clip_norm_is_the_global_norm(lm_case):
    """The clip reads the norm over every shard and replica: equal to
    optax's `global_norm` in the JAX step under every layout, and above
    the clip threshold, so every update here is clipped."""
    model, params, batches, _, got = lm_case
    _, norms, _ = _jax_steps(model, params, batches, (1, 2, 2), True)
    for layout in (*WORLD2, *WORLD4):
        np.testing.assert_allclose(got[layout]["norms"], norms, rtol=1e-5,
                                   err_msg=layout)
    assert min(norms) > CLIP


def test_tiny_llama_fsdp_bf16_matches_jax():
    """`fsdp_bf16`: bf16 parameters sharded over fsdp 2, AdamW and the
    clip; the losses agree within one bf16 ulp at their
    scale."""
    cfg = jl.llama_tiny_config(**LLAMA)
    model = jl.Llama(cfg)
    params = jax.device_get(model.init_params(jax.random.key(0), seq=T))
    batches = _batches(5)
    got = run_ranks(W.llama_run, 2, dict(
        mesh=(1, 2, 1), cfg=LLAMA, params=params, batches=batches, lr=LR,
        clip=CLIP, wd=WD), timeout=180)[0]
    losses, _, _ = _jax_steps(model, params, batches, (1, 2, 1), True,
                              policy="bf16_full")
    for a, b in zip(got["losses"], losses):
        ulp = 2.0 ** (np.floor(np.log2(abs(b))) - 7)
        assert abs(a - b) <= ulp, (got["losses"], losses)
