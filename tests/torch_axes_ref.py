"""The JAX side of the port's seq, pipe and expert tests: the JAX
package's sharded train step on a sub-mesh of the 8 forced host devices
(tests/conftest.py), and the batches and comparisons the three test
files share. The port's side runs on gloo ranks through
tests/torch_parallel_workers.py `axes_runs`.

Tolerances are tests/test_torch_parallel_train.py's, at its learning
rate 1e-4 (language_fsdp's): per-step losses and grad norms rtol 1e-5;
final parameters rtol 1e-5, atol 1e-6 after the steps, except each
attention's k_proj bias, whose gradient is rounding noise in both
packages and which AdamW moves by the sign of that noise: it is held to
AdamW's bound, lr a step. The same bound holds the odd element of
another leaf whose gradient is that small
(tests/test_torch_parallel_train.py saw one element of 16384 in an fc2
kernel 9.5e-6 apart at lr 1e-3; the pipe x fsdp step here, whose stage
gradients sum over the microbatch ticks and the fsdp ranks in another
order, one of 16384 in a v_proj kernel 1.9e-6 apart at lr 1e-4): at most
one element in 1000 of a leaf.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hyperion_tpu.parallel.partition import TRANSFORMER_TP_RULES
from hyperion_tpu.runtime.mesh import (
    MeshSpec,
    activate_mesh,
    batch_sharding,
    make_mesh,
)
from hyperion_tpu.train.losses import next_token_loss as jax_loss
from hyperion_tpu.train.state import create_train_state
from hyperion_tpu.train.state import make_optimizer as jax_optimizer
from hyperion_tpu.train.step import make_train_step as jax_train_step

LR, CLIP, WD = 1e-4, 0.5, 0.01
STEPS = 3
AXES = ("data", "fsdp", "model", "seq", "pipe", "expert")


def batches(seed: int, B: int = 8, T: int = 32, vocab: int = 256,
            steps: int = STEPS) -> list:
    """`steps` global batches: ids [B, T] and ragged right-padded masks
    (rows of 3 to T real tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, vocab, (B, T)).astype(np.int64)
        lens = rng.integers(3, T + 1, B)
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
        out.append((ids, mask))
    return out


def mesh6(shape: tuple):
    """The JAX mesh of a (data, fsdp, model, seq, pipe, expert) shape on
    the first devices."""
    n = int(np.prod(shape))
    return make_mesh(MeshSpec(**dict(zip(AXES, shape))),
                     devices=jax.devices()[:n])


def jax_steps(model, params, data, shape: tuple, fsdp: bool = False,
              aux: bool = False, steps: int | None = None):
    """The JAX package's train step on the sub-mesh of `shape` (the
    active mesh while it traces, as the trainer registers its own):
    per-step losses and grad norms, and the final params. `aux`: the
    MoE LM's `apply_with_aux` loss."""
    mesh = mesh6(shape)
    opt = jax_optimizer(LR, weight_decay=WD, grad_clip_norm=CLIP)
    with activate_mesh(mesh):
        state, sharding = create_train_state(
            lambda r: {"params": jax.tree.map(jnp.asarray, params)}, opt,
            mesh, jax.random.key(0), policy="fp32",
            tp_rules=TRANSFORMER_TP_RULES, fsdp=fsdp)

        def loss_fn(p, bs, batch, rngs):
            ids, mask = batch["input_ids"], batch["attention_mask"]
            if aux:
                logits, a = model.apply_with_aux({"params": p}, ids,
                                                 padding_mask=mask)
            else:
                logits = model.apply({"params": p}, ids, padding_mask=mask)
                a = 0.0
            loss = jax_loss(logits, ids, mask) + a
            return loss, ({"loss": loss}, bs)

        step = jax_train_step(loss_fn, opt, sharding, donate=False)
        losses, norms = [], []
        for ids, mask in data[:steps]:
            batch = {k: jax.device_put(v.astype(np.int32),
                                       batch_sharding(mesh))
                     for k, v in (("input_ids", ids),
                                  ("attention_mask", mask))}
            state, m = step(state, batch, jax.random.key(1))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, jax.device_get(state.params)


def flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, key)
        else:
            yield key, np.asarray(v, np.float32)


def assert_params_close(got: dict, want: dict, steps: int = STEPS):
    want, got = dict(flat(want)), dict(flat(got))
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w)
        if k.endswith("k_proj/bias"):
            assert err.max() <= 2 * steps * LR, k
            continue
        # AdamW divides each element's gradient by its own magnitude, so
        # an element whose gradient is rounding noise moves by the
        # noise's sign, up to lr a step: at most one element in 1000 of
        # a leaf may sit outside rtol 1e-5 / atol 1e-6, within that bound
        off = err > 1e-6 + 1e-5 * np.abs(w)
        assert off.sum() <= off.size // 1000, (k, int(off.sum()))
        assert err.max() <= 2 * steps * LR, k


def assert_run_matches(got: dict, want: tuple, params: bool = True):
    losses, norms, final = want
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5)
    if params:
        assert_params_close(got["params"], final, len(losses))


def run(shape: tuple, params: dict, data: list, **kw) -> dict:
    """One `axes_run` spec: the port's run of `data` on `shape`."""
    return dict(mesh=shape, fsdp=kw.pop("fsdp", False), params=params,
                batches=data, lr=LR, clip=CLIP, wd=WD, **kw)
