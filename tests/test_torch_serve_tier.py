"""The port engine's host KV tier (`serve/hostcache.py`) against the JAX
package's `generate`.

Re-expresses the reference's `TestTieredKV` (tests/test_serve.py):
radix eviction DEMOTES a chain to host RAM, a same-prefix re-hit
restores it (`tier=host`), the restored stream equals JAX `generate`,
and the drained store feeds a second engine after a restart. The
port's payloads are the pool's raw bits, so a bf16 pool round-trips
bit-exactly through `save`/`load` with no bfloat16-capable numpy
extension around, and a restored bf16 stream equals the never-evicted
one.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.hostcache import (
    HostBlockStore,
    HotRootTracker,
    prefix_root_digest,
)
from hyperion_tpu_torch.serve.queue import Request
from test_torch_serve import (  # noqa: F401 — `pair` is a fixture
    _assert_oracle,
    _drain,
    _engine,
    pair,
)

TIER = dict(slots=3, block_size=8, num_blocks=8, admission="optimistic",
            queue_capacity=16, host_cache_mb=8)


def _submit_all(eng, reqs, step_each=False):
    for r in reqs:
        ok, reason = eng.submit(r)
        assert ok, reason
        if step_each:
            eng.step()
    _drain(eng)


def _tier_drill(eng, rng):
    """Seed a shared 16-token prefix, push it out with growers, re-hit
    it. Returns (seed, growers, rehit)."""
    shared = rng.integers(1, 250, 16).astype(np.int32)
    seed = Request(prompt_ids=np.concatenate(
        [shared, rng.integers(1, 250, 3).astype(np.int32)]),
        max_new_tokens=4, id="tk_seed")
    _submit_all(eng, [seed])
    assert eng.prefix.evictable() >= 2
    growers = [Request(prompt_ids=rng.integers(1, 250, 6).astype(np.int32),
                       max_new_tokens=12, id=f"tk_gr{i}") for i in range(3)]
    _submit_all(eng, growers, step_each=True)
    rehit = Request(prompt_ids=np.concatenate(
        [shared, rng.integers(1, 250, 3).astype(np.int32)]),
        max_new_tokens=4, id="tk_rehit")
    _submit_all(eng, [rehit])
    return shared, seed, growers, rehit


class TestTieredKV:
    def test_evict_spill_restore_and_restart(self, pair, tmp_path):
        cache_dir = str(tmp_path / "hostcache")
        eng = _engine(pair, **TIER, host_cache_dir=cache_dir)
        eng.warmup()
        rng = np.random.default_rng(83)
        shared, seed, growers, rehit = _tier_drill(eng, rng)
        s = eng.metrics.summary()
        assert s["host_spilled_blocks"] >= 2, s
        assert s["tier_hits_host"] >= 1, s
        assert s["host_restored_blocks"] >= 2, s
        assert s["prefill_tokens_saved"] >= 16
        assert s["restore_bytes"] == s["host_restored_blocks"] \
            * eng._block_bytes
        _assert_oracle(pair, [seed, rehit] + growers)
        assert eng._hot_roots.top()[0] == prefix_root_digest(
            rehit.prompt_ids)

        # restart: the drain saves the store, a second engine loads it
        # and serves the prefix from host RAM without having decoded it
        eng.run()
        eng2 = _engine(pair, **TIER, host_cache_dir=cache_dir)
        assert len(eng2.host) >= 2
        surv = Request(prompt_ids=np.concatenate(
            [shared, rng.integers(1, 250, 3).astype(np.int32)]),
            max_new_tokens=4, id="tk_surv")
        _submit_all(eng2, [surv])
        assert eng2.metrics.summary()["tier_hits_host"] >= 1
        _assert_oracle(pair, [surv])

    def test_tier_off_by_default_and_needs_the_radix(self, pair):
        assert EngineConfig().host_cache_mb == 0
        assert _engine(pair, **{**TIER, "host_cache_mb": 0}).host is None
        assert _engine(pair, **TIER, prefix_cache=False).host is None
        eng = _engine(pair, **TIER)
        assert eng.host is not None and eng.host.dtype == "float32"
        assert eng.prefix.spill == eng._spill_block

    def test_restored_bf16_stream_equals_never_evicted(self, tmp_path):
        """A bf16 pool: the spilled chain comes back bit for bit, so the
        re-hit's stream equals the same request on an engine whose pool
        never evicts; the store saved from it loads into a bf16 engine
        and nothing into an fp32 one."""
        cfg = tl.llama_tiny_config(max_len=64, dtype="bfloat16")
        model = tl.Llama(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(5))
        cache_dir = str(tmp_path / "bf16")
        eng = Engine(model, EngineConfig(max_len=48, **TIER,
                                         host_cache_dir=cache_dir),
                     device="cpu")
        assert eng.host.dtype == "bfloat16"
        _, seed, growers, rehit = _tier_drill(
            eng, np.random.default_rng(84))
        assert eng.metrics.summary()["tier_hits_host"] >= 1
        roomy = Engine(model, EngineConfig(slots=3, max_len=48,
                                           block_size=8), device="cpu")
        clones = [Request(prompt_ids=r.prompt_ids, id=r.id,
                          max_new_tokens=r.max_new_tokens)
                  for r in [seed] + growers + [rehit]]
        _submit_all(roomy, clones)
        assert roomy.metrics.summary()["blocks_evicted"] == 0
        for r, c in zip([seed] + growers + [rehit], clones):
            assert r.tokens == c.tokens, r.id
        eng.run()
        bf = Engine(model, EngineConfig(max_len=48, **TIER,
                                        host_cache_dir=cache_dir),
                    device="cpu")
        assert len(bf.host) == len(eng.host) >= 2
        fp32 = tl.Llama(tl.llama_tiny_config(max_len=64), device="cpu")
        other = Engine(fp32, EngineConfig(max_len=48, **TIER,
                                          host_cache_dir=cache_dir),
                       device="cpu")
        assert len(other.host) == 0


class TestHostBlockStore:
    def test_bf16_round_trip_bit_exact_without_ml_dtypes(self, tmp_path,
                                                         monkeypatch):
        monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import fails
        with pytest.raises(ImportError):
            import ml_dtypes  # noqa: F401
        g = torch.Generator().manual_seed(0)
        store = HostBlockStore(1, 4, dtype="bfloat16")
        blocks = {}
        for i in range(3):
            kv = torch.randn(2, 2, 4, 2, 8, generator=g).to(torch.bfloat16)
            kv[0, 0, 0, 0, :4] = torch.tensor(
                [float("inf"), -0.0, 1e-40, float("nan")])
            key = tuple(range(4 * (i + 1)))
            blocks[key] = kv
            assert store.put(key, kv.view(torch.int16).numpy())
        store.save(str(tmp_path))
        back = HostBlockStore(1, 4, dtype="bfloat16")
        assert back.load(str(tmp_path)) == 3
        for key, kv in blocks.items():
            (raw,) = back.match(list(key) + [0], len(key) - 4, len(key))
            got = torch.from_numpy(raw).view(torch.bfloat16)
            assert torch.equal(got.view(torch.int16), kv.view(torch.int16))
        assert list(back._chains) == list(store._chains)  # LRU order kept

    @pytest.mark.parametrize("case", ["dtype", "block_size", "missing",
                                      "corrupt"])
    def test_load_refuses_alien_or_broken_stores(self, tmp_path, case):
        store = HostBlockStore(1, 4, dtype="bfloat16")
        store.put((1, 2, 3, 4), np.zeros((1, 2, 4, 1, 2), np.int16))
        store.save(str(tmp_path))
        if case == "corrupt":
            (tmp_path / "index.json").write_text("{not json")
        target = str(tmp_path / "nowhere") if case == "missing" \
            else str(tmp_path)
        kw = {"dtype": {"dtype": "float32"}.get(case, "bfloat16")}
        bs = 8 if case == "block_size" else 4
        assert HostBlockStore(1, bs, **kw).load(target) == 0

    def test_lru_budget_and_match_walk(self):
        payload = np.zeros((1, 2, 4, 1, 2), np.int32)  # 64 bytes
        store = HostBlockStore(1, 4)
        store.budget_bytes = 3 * payload.nbytes
        toks = list(range(1, 17))
        for n in (4, 8, 12, 16):
            assert store.put(toks[:n], payload)
        assert len(store) == 3 and store.evictions == 1
        # the root link fell out: a walk from 0 finds nothing, from 4 two
        assert store.match(toks, 0, 15) == []
        assert len(store.match(toks, 4, 15)) == 2
        with pytest.raises(ValueError):
            store.put(toks[:5], payload)
        store.budget_bytes = 10
        assert not store.put(toks[:4], payload) and store.rejected == 1

    def test_hot_roots_and_digest(self):
        assert prefix_root_digest([]) is None
        a = prefix_root_digest(range(40))
        assert a == prefix_root_digest(list(range(32)) + [7])  # 32 tokens
        tr = HotRootTracker(cap=2)
        for d in ("x", "y", "z", None, "y"):
            tr.note(d)
        assert tr.top() == ["y", "z"] and len(tr) == 2
