"""Speculative decoding in the port against the JAX package:
`accept_draft` (the acceptance rule the engine's spec tick shares),
the n-gram draft source, and `generate_speculative`, which must equal
greedy `generate` token for token whatever the draft proposes.

The target is `tests/test_torch_serve.py`'s tiny pair (JAX weights
loaded into the port), so its JAX `generate` references come from that
file's memo.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.infer import speculative as jspec
from hyperion_tpu.models import llama as jl
from hyperion_tpu.serve import draft as jdraft
from hyperion_tpu_torch.infer.generate import generate
from hyperion_tpu_torch.infer.speculative import (
    accept_draft,
    generate_speculative,
)
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.serve.draft import NgramDraft
from test_torch_serve import jax_streams, pair  # noqa: F401 — fixture

# ------------------------------------------------------------ accept rule


def _both(draft: np.ndarray, target: np.ndarray):
    jm, jv = jspec.accept_draft(jnp.asarray(draft), jnp.asarray(target))
    tm, tv = accept_draft(torch.as_tensor(draft), torch.as_tensor(target))
    return (np.asarray(jm), np.asarray(jv)), (tm.numpy(), tv.numpy())


@pytest.mark.parametrize("k", [1, 2, 4, 7])
@pytest.mark.parametrize("seed", range(4))
def test_accept_draft_matches_jax_on_seeded_rows(k, seed):
    """Rows over a 3-token vocabulary, so prefixes agree at every
    length; leading batch dims [4, 5]."""
    rng = np.random.default_rng(seed)
    draft = rng.integers(0, 3, (4, 5, k)).astype(np.int32)
    target = rng.integers(0, 3, (4, 5, k + 1)).astype(np.int32)
    # plant full and partial agreement in some rows
    target[0, :, :k] = draft[0]
    target[1, :, :k // 2] = draft[1, :, :k // 2]
    (jm, jv), (tm, tv) = _both(draft, target)
    np.testing.assert_array_equal(tm, jm)
    assert tm.dtype == np.int32
    # positions <= m are the decided tokens; above m both sides are junk
    # by contract, and both fill it the same way
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("case", ["no_match", "full_match", "k1_match",
                                  "k1_miss", "unbatched"])
def test_accept_draft_edges(case):
    if case == "no_match":
        draft = np.array([[5, 6, 7]], np.int32)
        target = np.array([[1, 2, 3, 4]], np.int32)
        want_m, want_v = [0], [[1, 6, 7, 0]]
    elif case == "full_match":
        draft = np.array([[5, 6, 7]], np.int32)
        target = np.array([[5, 6, 7, 9]], np.int32)
        want_m, want_v = [3], [[5, 6, 7, 9]]
    elif case == "k1_match":
        draft = np.array([[4], [2]], np.int32)
        target = np.array([[4, 8], [2, 2]], np.int32)
        want_m, want_v = [1, 1], [[4, 8], [2, 2]]
    elif case == "k1_miss":
        draft = np.array([[4]], np.int32)
        target = np.array([[3, 8]], np.int32)
        want_m, want_v = [0], [[3, 0]]
    else:
        draft = np.array([1, 2, 9], np.int32)
        target = np.array([1, 2, 3, 4], np.int32)
        want_m, want_v = 2, [1, 2, 3, 0]
    (jm, jv), (tm, tv) = _both(draft, target)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tm, want_m)
    np.testing.assert_array_equal(tv, want_v)


def test_accept_draft_rejects_mismatched_windows():
    with pytest.raises(ValueError, match="k\\+1"):
        accept_draft(torch.zeros(2, 3, dtype=torch.int32),
                     torch.zeros(2, 3, dtype=torch.int32))


# ----------------------------------------------------------- draft source


@pytest.mark.parametrize("max_ngram", [1, 2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_ngram_draft_matches_jax_copy(max_ngram, seed):
    """Contexts over a small vocabulary (repeats everywhere), prompt-only
    and with generated tokens, every k from 1 to 6."""
    rng = np.random.default_rng(100 + seed)
    ours, ref = NgramDraft(max_ngram), jdraft.NgramDraft(max_ngram)
    for n_prompt, n_gen in ((1, 0), (2, 0), (9, 0), (12, 5), (30, 17)):
        prompt = rng.integers(0, 5, n_prompt).astype(np.int32)
        gen = rng.integers(0, 5, n_gen).tolist()
        for k in range(1, 7):
            got = ours.propose(0, prompt, gen, k)
            np.testing.assert_array_equal(
                got, ref.propose(0, prompt, gen, k))
            assert got.dtype == np.int32 and got.shape == (k,)


def test_ngram_draft_rejects_bad_ngram():
    with pytest.raises(ValueError):
        NgramDraft(0)


# ------------------------------------------------------ generate_speculative


@functools.cache
def _draft_pair():
    """A 1-layer draft at the target's widths: JAX and port, same
    weights (the JAX default norm, so its reference stays cheap)."""
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64, n_layers=1))
    params = jax.device_get(jmodel.init_params(jax.random.key(1), seq=8))
    cfg = tl.llama_tiny_config(max_len=64, n_layers=1)
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    return jmodel, {"params": params}, model


PROMPTS = np.random.default_rng(7).integers(1, 250, (2, 8)).astype(np.int32)
N_NEW = 12


def _jax_greedy(pair, prompts, n):
    from test_torch_serve import _JAX_REFS, _key

    jax_streams(pair, [(p, n) for p in prompts])
    return [_JAX_REFS[_key(p, n, None)] for p in prompts]


@pytest.mark.parametrize("k", [1, 4])
def test_generate_speculative_equals_jax_generate(pair, k):
    """A 1-layer draft proposes, the 2-layer target verifies: both
    rows equal JAX greedy `generate` and the port's own."""
    draft = _draft_pair()[2]
    out = generate_speculative(pair[2], draft, PROMPTS, N_NEW, k=k,
                               device="cpu")
    assert out.dtype == torch.int64 and out.shape == (2, N_NEW)
    assert out.tolist() == _jax_greedy(pair, PROMPTS, N_NEW)
    assert out.tolist() == generate(pair[2], PROMPTS, N_NEW,
                                    device="cpu").tolist()


def test_generate_speculative_equals_jax_speculative(pair):
    """The JAX package's own `generate_speculative` on the same weights
    and the same draft."""
    jdm, jdv, draft = _draft_pair()
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64, norm_impl="pallas"))
    ref = jspec.generate_speculative(
        jmodel, pair[1], jdm, jdv, jnp.asarray(PROMPTS), N_NEW, k=3)
    out = generate_speculative(pair[2], draft, PROMPTS, N_NEW, k=3,
                               device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()


def test_generate_speculative_draft_is_target(pair):
    """The perfect draft: every round accepts all k (the bonus-token
    path and the draft window's re-feed after it)."""
    out = generate_speculative(pair[2], pair[2], PROMPTS[:1], N_NEW, k=4,
                               device="cpu")
    assert out.tolist() == _jax_greedy(pair, PROMPTS[:1], N_NEW)


def test_generate_speculative_eos_becomes_pad(pair):
    """generate's contract: after the first eos, pad."""
    stream = _jax_greedy(pair, PROMPTS[:1], N_NEW)[0]
    eos = stream[3]
    out = generate_speculative(pair[2], _draft_pair()[2], PROMPTS[:1],
                               N_NEW, k=4, eos_id=eos, pad_id=0,
                               device="cpu")[0].tolist()
    ref = generate(pair[2], PROMPTS[:1], N_NEW, eos_id=eos, pad_id=0,
                   device="cpu")[0].tolist()
    assert out == ref
    cut = stream.index(eos) + 1
    assert out[:cut] == stream[:cut] and set(out[cut:]) <= {0}


@pytest.mark.parametrize("case", ["k0", "short_prompt", "vocab",
                                  "max_len", "empty_batch"])
def test_generate_speculative_errors(pair, case):
    target, draft = pair[2], _draft_pair()[2]
    kw = dict(k=4, device="cpu")
    prompts, n = PROMPTS, N_NEW
    if case == "k0":
        kw["k"] = 0
    elif case == "short_prompt":
        prompts = PROMPTS[:, :4]
    elif case == "vocab":
        draft = tl.Llama(tl.llama_tiny_config(vocab_size=128, n_layers=1),
                         device="cpu")
    elif case == "max_len":
        n = 64 - 8 - 4  # no room for the k+1 slack
    else:
        prompts = np.zeros((0, 8), np.int32)
    with pytest.raises(ValueError):
        generate_speculative(target, draft, prompts, n, **kw)
