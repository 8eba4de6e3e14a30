"""Chunked prefill in the port engine against the JAX package's
`generate`.

Re-expresses the reference's `TestChunkedPrefill` (tests/test_serve.py):
long prompts fill the pool in [1, C] segments interleaved with decode
ticks, through pool-exhaustion preemption (slots 3,
block_size 8, num_blocks 8, optimistic), and every temperature-0 stream
equals JAX `generate`. Then every deferred decode path at once —
speculation, chunking and the host tier — as chip_smoke.py's oracle
phase runs them on the card.
"""

from __future__ import annotations

import numpy as np

from hyperion_tpu_torch.serve.queue import Request
from test_torch_serve import (  # noqa: F401 — `pair` is a fixture
    _assert_oracle,
    _drain,
    _engine,
    pair,
)
from test_torch_serve_spec import _counting

CHUNK = dict(slots=3, block_size=8, num_blocks=8, admission="optimistic",
             queue_capacity=16, prefill_chunk=16)


def long_requests(seed: int, n: int = 12) -> list[Request]:
    """Three families, one length and budget each so the JAX references
    batch: 24 tokens behind a shared 18-token prefix (chunked), 25 unrelated tokens (chunked), 5-token growers (one-shot
    prefill, preemption pressure)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, 18).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            ids = np.concatenate([shared, rng.integers(1, 250, 6)])
        elif i % 3 == 1:
            ids = rng.integers(1, 250, 25)
        else:
            ids = rng.integers(1, 250, 5)
        reqs.append(Request(prompt_ids=ids.astype(np.int32),
                            max_new_tokens=5 + (i % 3) * 4, id=f"c{i}"))
    return reqs


class TestChunkedPrefill:
    def test_chunked_churn_preemption(self, pair, monkeypatch):
        eng = _engine(pair, **CHUNK)
        # bucket(16) caps the sampling-prefill ladder
        eng.warmup()
        assert [k for k in eng.ledger.warmup["compile_s"]
                if k.startswith("prefill_b")] == ["prefill_b8", "prefill_b16"]
        calls = _counting(monkeypatch)
        eng.forwards = eng.chunk_segments = 0
        reqs = long_requests(77)
        for r in reqs:
            ok, reason = eng.submit(r)
            assert ok, reason
            eng.step()
        _drain(eng, max_steps=800)
        n = pair[2].cfg.n_layers
        assert calls == {"paged_attention": eng.forwards * n,
                         "fused_rmsnorm": eng.forwards * (2 * n + 1)}
        _assert_oracle(pair, reqs)
        s = eng.metrics.summary()
        assert eng.chunk_segments > 0, "no prompt was chunked"
        assert s["preempted"] > 0, "churn produced no preemption"
        assert not eng._chunking
        assert eng.mgr.reserved == 0
        assert eng.mgr.in_use == eng.prefix.evictable()

    def test_chunking_slot_stays_off_the_tick(self, pair):
        """While a slot chunks, its device table row is all null and the
        live mask excludes it, so the tick's write at a stale depth
        cannot land in the prompt's blocks; a neighbour decodes
        meanwhile, one segment per step."""
        eng = _engine(pair, block_size=8, prefill_chunk=8)
        short = Request(prompt_ids=np.arange(1, 6, dtype=np.int32),
                        max_new_tokens=10, id="short")
        long_ = Request(prompt_ids=np.arange(7, 40, dtype=np.int32),
                        max_new_tokens=4, id="long")
        eng.submit(short)
        eng.step()
        eng.submit(long_)
        seen = 0
        while long_.first_token_at is None:
            before = len(short.tokens)
            eng.step()
            slot = next(s for s, r in enumerate(eng._slots) if r is long_)
            if slot in eng._chunking:
                seen += 1
                assert not eng._bt[slot].any()
                assert not eng._live_mask()[slot]
                assert len(short.tokens) == before + 1
        assert seen == 4  # 33 tokens: 4 segments of 8, then the final 1
        _drain(eng)
        _assert_oracle(pair, [short, long_])


class TestAllDeferredPaths:
    def test_spec_chunk_and_host_tier_together(self, pair, tmp_path):
        """spec_k 4 with n-gram drafts, 16-token chunks and a host tier
        under the churn geometry: streams equal JAX `generate`, and
        chunk segments, accepted drafts, spills and restores all occur."""
        eng = _engine(pair, **CHUNK, spec_k=4, draft="ngram",
                      host_cache_mb=4)
        eng.warmup()
        reqs = long_requests(78)
        for r in reqs:
            ok, reason = eng.submit(r)
            assert ok, reason
            eng.step()
        _drain(eng, max_steps=800)
        # the shared prefix once more, after pressure evicted it
        again = Request(prompt_ids=np.concatenate(
            [reqs[0].prompt_ids[:18], reqs[3].prompt_ids[18:]]),
            max_new_tokens=5, id="again")
        eng.submit(again)
        _drain(eng)
        _assert_oracle(pair, reqs + [again])
        s = eng.metrics.summary()
        assert eng.chunk_segments > 0
        assert s["spec_accepted"] > 0, s
        assert s["host_spilled_blocks"] > 0 and s["host_restored_blocks"] > 0
