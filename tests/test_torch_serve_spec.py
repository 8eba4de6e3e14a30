"""The port engine's speculative tick against the JAX package's
`generate`.

Re-expresses the reference's `TestSpeculative` (tests/test_serve.py):
spec_k=4 with n-gram self-drafting through 12 requests of churn over an
undersized, optimistically admitted pool (slots 3, block_size 8,
num_blocks 8), so pool-exhaustion preemption happens mid-speculation,
and every temperature-0 stream still equals JAX `generate`. Each spec
tick is one forward: the kernel wrappers run `forwards × layers` (paged
attention) and `forwards × (2·layers + 1)` (RMSNorm) times, the counts
chip_smoke.py holds the card's launches to.
"""

from __future__ import annotations

import numpy as np
import pytest

from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.queue import Request
from test_torch_serve import (  # noqa: F401 — `pair` is a fixture
    _assert_oracle,
    _drain,
    _engine,
    _prompts,
    pair,
    port_stream,
)

SPEC = dict(slots=3, block_size=8, num_blocks=8, admission="optimistic",
            queue_capacity=16, spec_k=4, draft="ngram")


def churn_requests(seed: int, n: int = 12) -> list[Request]:
    """Three prompt families, one length and budget each so the JAX
    references batch: a shared 16-token prefix (radix hits, n-gram hits
    on the prefix's repeats), a prefix diverging mid-block (COW), and
    short growers that exhaust the pool."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, 16).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            ids = np.concatenate([shared, rng.integers(1, 250, 3)])
        elif i % 3 == 1:
            ids = np.concatenate([shared[:12], rng.integers(1, 250, 5)])
        else:
            ids = rng.integers(1, 250, 6)
        reqs.append(Request(prompt_ids=ids.astype(np.int32),
                            max_new_tokens=6 + (i % 3) * 5, id=f"q{i}"))
    return reqs


def _counting(monkeypatch) -> dict:
    calls = {"paged_attention": 0, "fused_rmsnorm": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tl, name, counted(name, getattr(tl, name)))
    return calls


class TestSpeculative:
    def test_spec_oracle_churn_preemption(self, pair, monkeypatch):
        eng = _engine(pair, **SPEC)
        eng.warmup()
        calls = _counting(monkeypatch)
        eng.forwards = 0
        reqs = churn_requests(35)
        for r in reqs:
            ok, reason = eng.submit(r)
            assert ok, reason
            eng.step()
        _drain(eng)
        n = pair[2].cfg.n_layers
        assert calls == {"paged_attention": eng.forwards * n,
                         "fused_rmsnorm": eng.forwards * (2 * n + 1)}
        _assert_oracle(pair, reqs)
        s = eng.metrics.summary()
        assert s["preempted"] > 0, "churn produced no preemption"
        assert s["prefix_hits"] > 0 and s["cow_copies"] > 0, s
        assert s["spec_drafted"] > 0 and s["spec_accepted"] > 0, s
        assert s["spec_drafted"] == s["spec_accepted"] + s["spec_rejected"]
        assert s["tokens_per_tick"] > 1.0, "no tick emitted > 1 token"
        assert eng.mgr.reserved == 0
        assert eng.mgr.in_use == eng.prefix.evictable()

    def test_spec_reserve_admission_and_eos(self, pair):
        """Reserve admission (the lookahead stays inside the worst-case
        span) and an eos that lands inside a verify window: the stream
        stops at the eos exactly as JAX `generate` with eos does."""
        from test_torch_serve import jax_stream

        probe = _prompts([9], seed=5)[0]
        probe = np.concatenate([probe, probe[:6]])  # repeats: drafts hit
        eos = port_stream(pair, probe, 12)[5]
        eng = _engine(pair, block_size=8, spec_k=4, draft="ngram",
                      eos_id=eos)
        req = Request(prompt_ids=probe, max_new_tokens=12)
        others = [Request(prompt_ids=p, max_new_tokens=7)
                  for p in _prompts([9, 9], seed=6)]
        for r in [req] + others:
            assert eng.submit(r)[0]
        _drain(eng)
        ref = jax_stream(pair, probe, 12, eos_id=eos)
        cut = ref.index(eos) + 1
        assert req.tokens == ref[:cut]
        _assert_oracle(pair, others)
        assert eng.mgr.reserved == 0

    def test_seeded_sampled_stream_same_with_spec_on_and_off(self, pair):
        """Every verify row draws at its own position, so a seeded
        stream is the same whether its drafts hit or miss."""
        probe = _prompts([8], seed=1)[0]  # its stream revisits itself

        def run(**kw):
            eng = _engine(pair, block_size=8, **kw)
            req = Request(prompt_ids=probe, max_new_tokens=16,
                          temperature=0.5, top_k=3, seed=42)
            eng.submit(req)
            for p in _prompts([7, 8], seed=10):
                eng.submit(Request(prompt_ids=p, max_new_tokens=9,
                                   temperature=1.0, seed=3))
            _drain(eng)
            return req.tokens, eng.metrics.summary()

        plain, _ = run()
        spec, s = run(spec_k=3, draft="ngram")
        assert spec == plain
        assert s["spec_accepted"] > 0, "no draft hit: the check is vacuous"

    @pytest.mark.parametrize("field, value", [
        ("draft", "beam"), ("spec_k", -1), ("prefill_chunk", -1),
        ("prefill_chunk", 49)])
    def test_bad_config_raises(self, pair, field, value):
        with pytest.raises(ValueError):
            _engine(pair, **{field: value})

    def test_spec_needs_both_window_and_draft(self, pair):
        assert EngineConfig().spec_k == 0 and EngineConfig().draft == "off"
        for kw in (dict(spec_k=4), dict(draft="ngram")):
            eng = Engine(pair[2], EngineConfig(slots=2, max_len=48, **kw),
                         device="cpu")
            assert not eng._spec and eng._drafter is None
