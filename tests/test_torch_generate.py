"""The port's sampling and `generate` against `hyperion_tpu/infer/generate.py`.

Temperature 0 is compared token for token with JAX `generate`. The
support restrictions (`_mask_top_p`, the per-row top-k threshold, the
composite of `sample_token_slots`) are compared mask for mask. Random
draws cannot match JAX's threefry bits, so temperature > 0 is checked by
its distribution (enough draws that a 5-sigma band is tight) and by the
port's own seed contract: the same seed and position give the same
token whatever shares the batch.
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
from hyperion_tpu_torch.infer import generate as tg
from hyperion_tpu_torch.models import llama as tl

# the JAX package's `infer/__init__` re-exports `generate`, which
# shadows the module of the same name as an attribute
jg = importlib.import_module("hyperion_tpu.infer.generate")


@pytest.fixture(scope="module")
def pair():
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64, norm_impl="pallas"))
    params = jax.device_get(jmodel.init_params(jax.random.key(0), seq=8))
    cfg = tl.llama_tiny_config(max_len=64, norm_impl="pallas")
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    # JAX `generate` under one jit: one compile per shape, same tokens
    jgen = jax.jit(functools.partial(jg.generate, jmodel),
                   static_argnums=(2,), static_argnames=("eos_id", "pad_id"))
    return jgen, {"params": params}, model


def _first_divergence_margin(model, prompt, ref):
    """(index, top-2 logit margin) where `ref` is first not argmax — a
    near-tie there is a numerics coin flip, not a port fault."""
    ids = np.asarray(prompt, np.int64)
    for i, tok in enumerate(ref):
        logits, _ = model(torch.as_tensor(ids)[None],
                          cache=tl.init_cache(model.cfg, 1, len(ids),
                                              device="cpu"), cache_index=0)
        top2 = torch.topk(logits[0, -1], 2)
        if int(top2.indices[0]) != tok:
            return i, float(top2.values[0] - top2.values[1])
        ids = np.append(ids, tok)
    return None, None


class TestGreedyGenerate:
    def test_streams_match_jax_generate(self, pair):
        jgen, variables, model = pair
        prompts = np.random.default_rng(0).integers(1, 250, (3, 7))
        prompts = prompts.astype(np.int32)
        ref = np.asarray(jgen(variables, jnp.asarray(prompts), 12))
        out = tg.generate(model, prompts, 12, device="cpu").numpy()
        for row in range(3):
            if out[row].tolist() != ref[row].tolist():
                i, margin = _first_divergence_margin(
                    model, prompts[row], ref[row].tolist())
                pytest.fail(f"row {row} diverges at token {i} (top-2 margin "
                            f"{margin}): {out[row]} != {ref[row]}")

    def test_eos_pads_like_jax(self, pair):
        jgen, variables, model = pair
        prompt = np.random.default_rng(3).integers(1, 250, (1, 6))
        prompt = prompt.astype(np.int32)
        free = tg.generate(model, prompt, 10, device="cpu")[0]
        eos = int(free[2])
        ref = np.asarray(jgen(variables, jnp.asarray(prompt), 10,
                              eos_id=eos, pad_id=0))[0]
        out = tg.generate(model, prompt, 10, eos_id=eos, pad_id=0,
                          device="cpu")[0].numpy()
        assert out.tolist() == ref.tolist()
        cut = int(np.argmax(out == eos))   # eos delivered, then pad
        assert cut <= 2 and (out[cut + 1:] == 0).all()

    def test_temperature_needs_a_generator(self, pair):
        _, _, model = pair
        with pytest.raises(ValueError, match="Generator"):
            tg.generate(model, np.ones((1, 3), np.int32), 2,
                        temperature=0.7, device="cpu")

    def test_seeded_generator_repeats_its_stream(self, pair):
        _, _, model = pair
        p = np.ones((2, 4), np.int32)
        runs = [tg.generate(model, p, 8, temperature=1.0, top_k=20,
                            generator=torch.Generator().manual_seed(5),
                            device="cpu") for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


def _logits(rows=6, vocab=50, seed=0):
    return np.random.default_rng(seed).normal(0, 2.0, (rows, vocab)) \
        .astype(np.float32)


class TestSupportMasks:
    @pytest.mark.parametrize("per_row", [False, True])
    def test_mask_top_p_matches_jax(self, per_row):
        lg = _logits()
        p = np.array([0.5, 0.9, 1.0, 0.3, 0.75, 0.95], np.float32)
        jp = jnp.asarray(p)[:, None] if per_row else 0.8
        tp = torch.from_numpy(p)[:, None] if per_row else 0.8
        ref = np.asarray(jg._mask_top_p(jnp.asarray(lg), jp))
        out = tg._mask_top_p(torch.from_numpy(lg), tp).numpy()
        np.testing.assert_array_equal(out, ref)

    def test_per_row_top_k_threshold_matches_jax(self):
        lg = _logits(seed=1)
        k = np.array([0, 1, 5, 50, 80, 3], np.int32)
        # the reference's inline top-k step (generate.py:109-116)
        V = lg.shape[-1]
        kj = jnp.clip(jnp.asarray(k), 0, V)
        sorted_desc = -jnp.sort(-jnp.asarray(lg), axis=-1)
        kth = jnp.take_along_axis(
            sorted_desc, jnp.clip(kj - 1, 0, V - 1)[:, None], axis=-1)
        ref = np.asarray(jnp.where((kj > 0)[:, None] & (lg < kth),
                                   -jnp.inf, lg))
        out = tg._mask_top_k_rows(torch.from_numpy(lg),
                                  torch.from_numpy(k).long()).numpy()
        np.testing.assert_array_equal(out, ref)

    def test_greedy_rows_match_jax_sample_token_slots(self):
        lg = _logits(seed=2)
        temp = np.array([0.0, 0.7, 0.0, 1.3, 0.0, 0.5], np.float32)
        top_k = np.array([0, 5, 3, 0, 0, 10], np.int32)
        top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.8, 0.9], np.float32)
        ref = np.asarray(jg.sample_token_slots(
            jnp.asarray(lg), jax.random.split(jax.random.key(0), 6),
            jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))
        out = tg.sample_token_slots(torch.from_numpy(lg), temp, top_k, top_p,
                                    seeds=range(6), positions=[0] * 6).numpy()
        greedy = temp == 0
        np.testing.assert_array_equal(out[greedy], ref[greedy])
        # drawn rows stay inside their restricted support
        support = np.isfinite(tg.restrict_slots(
            torch.from_numpy(lg), torch.from_numpy(temp),
            torch.from_numpy(top_k).long(), torch.from_numpy(top_p)).numpy())
        assert all(support[r, out[r]] for r in range(6))


def _expected(logits, temperature, top_k, top_p):
    """The restricted softmax, in float64 numpy, from first principles."""
    z = np.asarray(logits, np.float64) / temperature
    order = np.argsort(-z, kind="stable")
    keep = np.zeros_like(z, bool)
    if top_k:
        keep[order[:top_k]] = True
    else:
        keep[:] = True
    zs = np.where(keep, z, -np.inf)
    p = np.exp(zs - zs.max())
    p /= p.sum()
    ps = p[order]
    before = np.cumsum(ps) - ps
    nucleus = np.zeros_like(keep)
    nucleus[order[before < top_p]] = True
    p = np.where(keep & nucleus, p, 0.0)
    return p / p.sum()


class TestDraws:
    @pytest.mark.parametrize("temperature, top_k, top_p", [
        (0.7, 0, 0.9), (1.0, 3, 1.0), (1.5, 0, 1.0)])
    def test_frequencies_follow_the_restricted_softmax(self, temperature,
                                                       top_k, top_p):
        row = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0],
                       np.float32)
        n = 4000
        lg = torch.from_numpy(np.tile(row, (n, 1)))
        toks = tg.sample_token_slots(
            lg, np.full(n, temperature), np.full(n, top_k),
            np.full(n, top_p), seeds=np.arange(n), positions=np.zeros(n))
        freq = np.bincount(toks.numpy(), minlength=row.size) / n
        p = _expected(row, temperature, top_k, top_p)
        band = 5 * np.sqrt(p * (1 - p) / n) + 1e-9
        assert (np.abs(freq - p) <= band).all(), (freq, p)
        assert (freq[p == 0] == 0).all()

    def test_same_seed_and_position_same_token_any_batch(self):
        lg = torch.from_numpy(_logits(rows=4, seed=4))
        temp = np.full(4, 1.0)
        alone = tg.sample_token_slots(lg[2:3], temp[:1], [0], [1.0],
                                      seeds=[7], positions=[13])
        batch = tg.sample_token_slots(lg, temp, [0] * 4, [1.0] * 4,
                                      seeds=[1, 2, 7, 9],
                                      positions=[0, 5, 13, 2])
        assert int(alone[0]) == int(batch[2])
        # the position is part of the draw: a stream is not one token
        draws = {int(tg.sample_token_slots(lg[2:3], temp[:1], [0], [1.0],
                                           seeds=[7], positions=[p])[0])
                 for p in range(40)}
        assert len(draws) > 1

    def test_greedy_rows_never_draw(self, monkeypatch):
        calls = []
        real = tg._gumbel_argmax
        monkeypatch.setattr(tg, "_gumbel_argmax",
                            lambda r, g: calls.append(1) or real(r, g))
        lg = torch.from_numpy(_logits(rows=3))
        out = tg.sample_token_slots(lg, [0.0, 0.0, 0.0], [0] * 3, [1.0] * 3,
                                    seeds=[1, 2, 3], positions=[0, 0, 0])
        assert calls == []
        assert torch.equal(out, lg.argmax(-1))
