"""The port's continuous-batching engine and JSONL server against the
JAX package's `generate`.

Re-expresses the reference's serving oracles (tests/test_serve.py:
`TestOracle`, `TestPagedAttnPallas`, the `TestPagedCache` churn): at
temperature 0 every request decoded through the engine — while other
slots churn, share its blocks, COW-fork them, or get preempted around
it — emits exactly the tokens both the port's `generate` and JAX
`generate` emit for its prompt. On the CPU the engine's attention runs
the kernel wrapper's plain version; the test counts the wrapper calls
the forwards make, the same count chip_smoke.py holds the CUDA launch
counters to.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hyperion_tpu.models import llama as jl
from hyperion_tpu_torch.infer.generate import generate
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.queue import Request

jg = importlib.import_module("hyperion_tpu.infer.generate")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@functools.cache
def build_pair():
    """(jitted JAX generate, JAX variables, port model) — built once a
    process, so the serve test files that share this fixture share the
    JAX compiles and the memo of JAX streams."""
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64, norm_impl="pallas"))
    params = jax.device_get(jmodel.init_params(jax.random.key(0), seq=8))
    cfg = tl.llama_tiny_config(max_len=64, norm_impl="pallas")
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    # JAX `generate` under one jit: a single compile per (batch, prompt
    # length, budget) instead of an eager prefill plus a scan compile
    jgen = jax.jit(functools.partial(jg.generate, jmodel),
                   static_argnums=(2,), static_argnames=("eos_id", "pad_id"))
    return jgen, {"params": params}, model


_JAX_REFS: dict = {}


def _key(prompt, n, eos_id):
    return tuple(int(t) for t in prompt), n, eos_id


def jax_streams(pair, jobs, eos_id=None) -> None:
    """Fill the memo with JAX `generate` for every (prompt, n) in
    `jobs`, one batched call per (prompt length, n): each call compiles
    its own decode scan, so batching equal shapes is what keeps this
    cheap."""
    jgen, variables, _ = pair
    groups: dict = {}
    for prompt, n in jobs:
        if _key(prompt, n, eos_id) not in _JAX_REFS:
            groups.setdefault((len(prompt), n), []).append(prompt)
    for (_, n), prompts in groups.items():
        out = np.asarray(jgen(variables, jnp.asarray(np.stack(prompts)), n,
                              eos_id=eos_id, pad_id=0))
        for prompt, row in zip(prompts, out):
            _JAX_REFS[_key(prompt, n, eos_id)] = row.tolist()


def jax_stream(pair, prompt, n, eos_id=None) -> list[int]:
    jax_streams(pair, [(prompt, n)], eos_id)
    return _JAX_REFS[_key(prompt, n, eos_id)]


def port_stream(pair, prompt, n, eos_id=None) -> list[int]:
    return generate(pair[2], np.asarray(prompt)[None], n, eos_id=eos_id,
                    device="cpu")[0].tolist()


def _engine(pair, **kw) -> Engine:
    cfg = dict(slots=3, max_len=48, eos_id=None)
    cfg.update(kw)
    return Engine(pair[2], EngineConfig(**cfg), device="cpu")


def _drain(engine, max_steps=500):
    steps = 0
    while not engine.idle:
        engine.step()
        steps += 1
        assert steps < max_steps, "engine failed to drain"


def _assert_oracle(pair, reqs):
    jax_streams(pair, [(r.prompt_ids, r.max_new_tokens) for r in reqs])
    for r in reqs:
        assert r.status == "done", r.id
        port = port_stream(pair, r.prompt_ids, r.max_new_tokens)
        assert r.tokens == port, f"{r.id}: engine {r.tokens} != port {port}"
        ref = jax_stream(pair, r.prompt_ids, r.max_new_tokens)
        assert r.tokens == ref, f"{r.id}: engine {r.tokens} != jax {ref}"


def _prompts(ns, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, n).astype(np.int32) for n in ns]


# lengths and budgets pair up so the JAX references batch in fours
ORACLE_PROMPTS = _prompts([5, 9, 5, 9, 7, 7, 12, 12])
ORACLE_BUDGETS = [4, 7, 4, 7, 10, 10, 6, 6]


def _budget(i):
    return ORACLE_BUDGETS[i]


class TestOracle:
    def test_temp0_streams_under_slot_churn(self, pair):
        """8 requests through 3 slots: refills all the way."""
        eng = _engine(pair, block_size=8)
        eng.warmup([8, 16])
        reqs = [Request(prompt_ids=p, max_new_tokens=_budget(i), id=f"r{i}")
                for i, p in enumerate(ORACLE_PROMPTS)]
        for r in reqs:
            ok, reason = eng.submit(r)
            assert ok, reason
        _drain(eng)
        _assert_oracle(pair, reqs)

    def test_eos_stops_request(self, pair):
        probe = _prompts([6], seed=3)[0]
        eos = port_stream(pair, probe, 10)[2]
        eng = _engine(pair, eos_id=eos)
        req = Request(prompt_ids=probe, max_new_tokens=10)
        eng.submit(req)
        _drain(eng)
        ref = jax_stream(pair, probe, 10, eos_id=eos)
        cut = int(np.argmax(np.asarray(ref) == eos)) + 1
        assert req.tokens == ref[:cut]
        assert req.tokens[-1] == eos and eng.n_active == 0


class TestKernelPath:
    def test_every_forward_goes_through_the_kernel_wrappers(
            self, pair, monkeypatch):
        """Shared-prefix requests (radix hits, then COW) through 2 slots:
        streams match, and each forward calls paged attention once per
        layer and the norm 2*layers+1 times — on the card, those calls
        are the kernel launches."""
        calls = {"paged_attention": 0, "fused_rmsnorm": 0}

        def counted(name, fn):
            def wrapper(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return wrapper

        monkeypatch.setattr(tl, "paged_attention",
                            counted("paged_attention", tl.paged_attention))
        monkeypatch.setattr(tl, "fused_rmsnorm",
                            counted("fused_rmsnorm", tl.fused_rmsnorm))
        eng = _engine(pair, slots=2, max_len=32, block_size=8)
        rng = np.random.default_rng(11)
        head = rng.integers(1, 250, 5)
        reqs = [Request(prompt_ids=np.concatenate(
            [head, rng.integers(1, 250, 1 + i % 3)]).astype(np.int32),
            max_new_tokens=3 + i % 3, id=f"p{i}") for i in range(4)]
        for r in reqs:
            ok, reason = eng.submit(r)
            assert ok, reason
        _drain(eng)
        n = pair[2].cfg.n_layers
        assert calls == {"paged_attention": eng.forwards * n,
                         "fused_rmsnorm": eng.forwards * (2 * n + 1)}
        _assert_oracle(pair, reqs)


class TestPagedCache:
    def test_churn_with_hits_cow_and_preemption(self, pair):
        """8 requests through 3 slots over an undersized, optimistically
        admitted pool: prefix hits, COW forks and pool-exhaustion
        preemptions all occur; every stream still matches; the pool
        accounts to zero at drain."""
        eng = _engine(pair, slots=3, block_size=8, num_blocks=8,
                      admission="optimistic", queue_capacity=16)
        eng.warmup()
        rng = np.random.default_rng(35)
        shared = rng.integers(1, 250, 16).astype(np.int32)
        reqs = []
        for i in range(8):
            # one prompt length per family: the JAX references batch
            if i % 3 == 0:    # shared-prefix family (hits)
                ids = np.concatenate([shared, rng.integers(1, 250, 3)])
            elif i % 3 == 1:  # mid-block divergent family (COW)
                ids = np.concatenate([shared[:12], rng.integers(1, 250, 5)])
            else:             # growers (preemption pressure)
                ids = rng.integers(1, 250, 6)
            reqs.append(Request(prompt_ids=ids.astype(np.int32),
                                max_new_tokens=6 + (i % 3) * 5,
                                id=f"churn{i}"))
        for r in reqs:
            ok, reason = eng.submit(r)
            assert ok, reason
            eng.step()
        _drain(eng)
        _assert_oracle(pair, reqs)
        s = eng.metrics.summary()
        assert s["prefix_hits"] > 0, "churn produced no prefix hits"
        assert s["cow_copies"] > 0, "churn produced no COW forks"
        assert s["preempted"] > 0, "churn produced no preemption"
        assert eng.mgr.reserved == 0
        assert eng.mgr.in_use == eng.prefix.evictable(), (
            "blocks leaked beyond the radix cache's retained prefixes")


class TestEngineContract:
    def test_sampled_stream_is_seed_deterministic(self, pair):
        """Temperature > 0: the same request replays the same stream in
        a fresh engine, whatever shares its batch."""
        def run(extra):
            eng = _engine(pair)
            req = Request(prompt_ids=ORACLE_PROMPTS[1], max_new_tokens=8,
                          temperature=0.9, top_p=0.9, seed=42, id="s")
            eng.submit(req)
            for p in extra:
                eng.submit(Request(prompt_ids=p, max_new_tokens=5,
                                   temperature=1.0, seed=1))
            _drain(eng)
            return req.tokens

        assert run([]) == run(ORACLE_PROMPTS[2:4])

    @pytest.mark.parametrize("field, value", [("ledger_costs", True)])
    def test_unported_features_raise(self, pair, field, value):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _engine(pair, **{field: value})

    def test_journal_is_not_ported(self, pair):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(pair[2], EngineConfig(), journal=object(), device="cpu")

    def test_default_device_raises_without_cuda(self, pair):
        """No silent CPU fallback: the default device is cuda:0."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tl.Llama(tl.llama_tiny_config())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Engine(pair[2], EngineConfig())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            generate(pair[2], np.ones((1, 3), np.int32), 2)


class TestServer:
    def test_jsonl_subprocess_streams_match_jax(self, pair, tmp_path):
        """`python -m hyperion_tpu_torch.serve.server` over a JAX
        export: three requests in, token and done lines out, tokens
        equal to JAX `generate`."""
        flat = traverse_util.flatten_dict(pair[1]["params"], sep="/")
        ckpt = tmp_path / "tiny.npz"
        np.savez(ckpt, **{k: np.asarray(v) for k, v in flat.items()})
        lines = [json.dumps({"id": f"q{i}", "prompt_ids": p.tolist(),
                             "max_new_tokens": _budget(i)})
                 for i, p in enumerate(ORACLE_PROMPTS[:3])]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("HYPERION_TELEMETRY", None)
        proc = subprocess.run(
            [sys.executable, "-m", "hyperion_tpu_torch.serve.server",
             "--device", "cpu", "--dtype", "float32", "--ckpt", str(ckpt),
             "--no-tokenizer", "--max-len", "64", "--slots", "2"],
            input="\n".join(lines) + "\n", capture_output=True, text=True,
            cwd=tmp_path, env=env, timeout=240)
        assert proc.returncode == 0, proc.stderr
        recs = [json.loads(x) for x in proc.stdout.splitlines()]
        for i, p in enumerate(ORACLE_PROMPTS[:3]):
            toks = [r["token"] for r in recs
                    if r["id"] == f"q{i}" and r["event"] == "token"]
            done = [r for r in recs
                    if r["id"] == f"q{i}" and r["event"] == "done"]
            assert toks == jax_stream(pair, p, _budget(i)), f"q{i}"
            assert len(done) == 1 and done[0]["n_tokens"] == _budget(i)
