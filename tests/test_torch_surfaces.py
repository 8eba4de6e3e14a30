"""The port's surfaces that the reference has and the port refused until
now, against the JAX package on the CPU, and the D 256 flash path in a
model.

  * `serve --paged-attn {gather,pallas}`: both parse with the
    reference's choices (the port's default is the kernel), both serve
    `generate`'s stream, and the memory ledger's gather bytes follow the
    impl;
  * `train --compile-cache DIR` and HYPERION_COMPILE_CACHE move the
    CUDA kernels' library cache, in-process (no nvcc needed here);
  * `Config.to_dict/save/load/from_dict/override`, `default_config`,
    `HardwareConfig`, `BenchmarkingConfig`: a JSON either package saves
    loads into the other field by field;
  * `save_token_file` and `TextSplit.seq_len`: a token file either
    package writes is read back by the other;
  * the drift guards over the port's own sources
    (`scripts/check_diff_gates_torch.py`, `check_event_vocab_torch.py`):
    they pass on the tree and fail on a producer renamed in a copy;
  * a TransformerLM at head_dim 256 with `attention_impl="pallas"`
    against the JAX model (whose flash kernel runs in interpret mode):
    logits 1e-5, each gradient leaf 1e-4 of its largest entry (the
    tolerances of tests/test_torch_train.py).

Inputs come from numpy seeds; weights cross over with
`params_from_jax`. Slowest (`--durations`, one CPU process): the D 256
TransformerLM against JAX's ~14 s, the `train --compile-cache`
subprocess ~9 s, the `serve --paged-attn gather` subprocess ~8 s; the
rest under 2 s each.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hyperion_tpu import config as jcfg
from hyperion_tpu.data import text as jtext
from hyperion_tpu.models import llama as jl
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu.serve import hostcache as jhost
from hyperion_tpu.serve.server import build_parser as jax_serve_parser
from hyperion_tpu_torch import config as tcfg
from hyperion_tpu_torch.cli import main as tcli
from hyperion_tpu_torch.data import text as ttext
from hyperion_tpu_torch.infer.generate import generate
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.models import transformer_lm as tt
from hyperion_tpu_torch.ops import build
from hyperion_tpu_torch.serve import hostcache as thost
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.queue import Request
from hyperion_tpu_torch.serve.server import build_parser

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- flash in a model


def test_d256_lm_logits_and_grads_match_jax():
    """d_model 256, one head: the flash path at D 256 through the
    model's attention, fp32, dropout off. The activation is gelu (the
    GPT-2 config's): under relu one fc1 pre-activation of this input
    lies within 3e-6 of zero, and the 1e-6 by which any two fp32
    attentions differ (the port's "xla" against its "pallas") flips its
    sign, moving the gradients below it by 1e-2 of their scale."""
    kw = dict(vocab_size=1000, d_model=256, n_heads=1, n_layers=2,
              ff_dim=256, max_len=16, dropout=0.0, activation="gelu",
              attention_impl="pallas")
    jmodel = jt.TransformerLM(jt.simple_lm_config(**kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(0)))
    cfg = tt.simple_lm_config(**kw)
    assert cfg.head_dim == 256
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, cfg))
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 1000, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int8)
    mask[1, 11:] = 0

    def jlogits(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            padding_mask=jnp.asarray(mask))

    ref = np.asarray(jlogits(params))
    ref_grads = jax.device_get(jax.grad(lambda p: jlogits(p).sum())(params))
    out = model(_t(ids), padding_mask=_t(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    out.sum().backward()
    grads = tt.state_to_jax({n: p.grad for n, p in model.named_parameters()},
                            cfg)
    leaves = list(zip(jax.tree_util.tree_leaves_with_path(grads),
                      jax.tree_util.tree_leaves_with_path(ref_grads)))
    largest = max(np.abs(np.asarray(r)).max() for _, (_, r) in leaves)
    for (path, g), (_, r) in leaves:
        # a bias whose gradient is zero in exact arithmetic (k_proj's)
        # is held to the largest leaf's scale
        scale = max(np.abs(np.asarray(r)).max(), 1e-4 * largest)
        assert np.abs(g - np.asarray(r)).max() <= 1e-4 * scale, path


# ------------------------------------------------------- serve --paged-attn


def test_paged_attn_flag_takes_the_references_choices():
    ours = build_parser()._option_string_actions["--paged-attn"]
    ref = jax_serve_parser()._option_string_actions["--paged-attn"]
    assert tuple(ours.choices) == tuple(ref.choices) == ("gather", "pallas")
    # by design: the reference reads the gather path by default, the
    # port its kernel (ROADMAP C)
    assert ref.default == "gather" and ours.default == "pallas"
    for impl in ("gather", "pallas"):
        args = build_parser().parse_args(["--ckpt", "x.npz",
                                          "--paged-attn", impl])
        assert args.paged_attn == impl
    assert tl.LlamaConfig().paged_attn_impl == "pallas"
    with pytest.raises(ValueError, match="paged_attn_impl"):
        tl.llama_tiny_config(paged_attn_impl="flash")


def _tiny_llama():
    model = tl.Llama(tl.llama_tiny_config(max_len=64), device="cpu")
    return model.init_params(torch.Generator().manual_seed(3))


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 250, n).astype(np.int32) for n in (5, 9, 7)]


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_both_impls_serve_the_generate_stream(impl):
    """On the CPU both reads are the plain gather read; the switch
    reaches every attention module and leaves the weights alone."""
    model = _tiny_llama()
    weights = {n: p.clone() for n, p in model.state_dict().items()}
    tl.set_paged_attn(model, impl)
    assert model.cfg.paged_attn_impl == impl
    assert all(m.c is model.cfg for m in model.modules()
               if isinstance(m, tl.LlamaAttention))
    for n, p in model.state_dict().items():
        assert torch.equal(p, weights[n]), n
    eng = Engine(model, EngineConfig(slots=2, max_len=48, eos_id=None),
                 device="cpu")
    reqs = [Request(prompt_ids=p, max_new_tokens=6, id=f"r{i}")
            for i, p in enumerate(_prompts())]
    for r in reqs:
        assert eng.submit(r)[0]
    while not eng.idle:
        eng.step()
    for r in reqs:
        assert r.tokens == generate(model, r.prompt_ids[None], 6,
                                    device="cpu")[0].tolist(), r.id


def test_ledger_gather_bytes_follow_the_impl(monkeypatch):
    """slots x MB x block bytes for the gather read, 0 for the kernel,
    which runs only for a CUDA tensor: the device is claimed to be the
    card, as memory_ledger reads only its type."""
    model = _tiny_llama()
    eng = Engine(model, EngineConfig(slots=3, max_len=48, eos_id=None),
                 device="cpu")
    copy = 3 * eng._mb * eng._block_bytes
    assert copy > 0
    got = {}
    for impl in ("gather", "pallas"):
        tl.set_paged_attn(model, impl)
        cpu = eng.memory_ledger()["kv_gather_bytes_per_tick"]
        with monkeypatch.context() as m:
            m.setattr(eng, "device", torch.device("cuda"))
            got[impl] = eng.memory_ledger()["kv_gather_bytes_per_tick"]
        assert cpu == copy  # a CPU tensor always takes the gather read
    assert got == {"gather": copy, "pallas": 0}


def test_serve_cli_takes_paged_attn_gather(tmp_path):
    """`python -m hyperion_tpu_torch.cli.main serve --paged-attn gather`
    over a JAX export: the token lines equal `generate` on the same
    weights."""
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64))
    params = jax.device_get(jmodel.init_params(jax.random.key(1), seq=8))
    flat = traverse_util.flatten_dict(params, sep="/")
    ckpt = tmp_path / "tiny.npz"
    np.savez(ckpt, **{k: np.asarray(v) for k, v in flat.items()})
    cfg = tl.llama_tiny_config(max_len=64)
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    prompts = _prompts()[:2]
    lines = [json.dumps({"id": f"q{i}", "prompt_ids": p.tolist(),
                         "max_new_tokens": 5}) for i, p in enumerate(prompts)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("HYPERION_TELEMETRY", None)
    proc = subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "serve",
         "--device", "cpu", "--dtype", "float32", "--ckpt", str(ckpt),
         "--no-tokenizer", "--max-len", "64", "--slots", "2",
         "--paged-attn", "gather"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(x) for x in proc.stdout.splitlines()]
    for i, p in enumerate(prompts):
        toks = [r["token"] for r in recs
                if r["id"] == f"q{i}" and r["event"] == "token"]
        assert toks == generate(model, p[None], 5, device="cpu")[0].tolist()


# ------------------------------------------------------ --compile-cache


@pytest.fixture
def cache_state(monkeypatch):
    """The library cache as the process had it, restored after."""
    monkeypatch.setattr(build, "_cache_dir", None)
    monkeypatch.delenv(build.COMPILE_CACHE_ENV, raising=False)
    return monkeypatch


def test_compile_cache_flag_then_variable_then_default(cache_state,
                                                       tmp_path):
    env_before = dict(os.environ)
    assert tcli.setup_compile_cache("") is None
    assert build.build_root() == build.BUILD_ROOT
    cache_state.setenv(build.COMPILE_CACHE_ENV, str(tmp_path / "var"))
    assert tcli.setup_compile_cache("") == tmp_path / "var"
    assert build.build_root() == tmp_path / "var"
    assert tcli.setup_compile_cache(str(tmp_path / "flag")) \
        == tmp_path / "flag"  # the flag wins
    assert build.build_root() == tmp_path / "flag"
    env_before[build.COMPILE_CACHE_ENV] = str(tmp_path / "var")
    assert dict(os.environ) == env_before  # nothing written to it


def test_libraries_load_from_the_cache_dir_without_nvcc(cache_state,
                                                        tmp_path):
    """Libraries already in the cache dir (another checkout's build of
    the same sources) are what `build_all` returns: nothing is built,
    so no nvcc is asked for."""
    build.set_cache_dir(tmp_path)
    sources = build._sources()
    out = tmp_path / build._digest(sources)
    out.mkdir()
    for src in sources:
        (out / f"lib{src.stem}.so").write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc asked for")

    cache_state.setattr(build, "find_nvcc", no_nvcc)
    libs = build.build_all()
    assert set(libs) == {s.stem for s in sources}
    assert all(p.parent == out for p in libs.values())


def test_train_cli_carries_the_compile_cache(cache_state, tmp_path):
    args = tcli.build_parser().parse_args(["--compile-cache", "cc"])
    assert tcli.make_config(args, "language_ddp").optimization \
        .compile_cache == "cc"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("HYPERION_TELEMETRY", None)
    proc = subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "train",
         "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
         "--batch_size", "2", "--seq_len", "8", "--no-validate",
         "--base_dir", str(tmp_path / "run"),
         "--data_dir", str(tmp_path / "none"),
         "--compile-cache", str(tmp_path / "libs")],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"CUDA kernel libraries under {tmp_path / 'libs'}" in proc.stdout


# ------------------------------------------------------------- Config


def _plain(d):
    """A config dict as JSON gives it back (tuples as lists)."""
    return json.loads(json.dumps(d, default=list))


def test_reference_saved_config_loads_field_by_field(tmp_path):
    ref = jcfg.default_config().override(**{
        "train.epochs": 7, "optimization.compile_cache": "cc",
        "distributed.fsdp": 2, "hardware.chips_expected": 4,
        "benchmarking.batch_sizes": (1, 2), "train.lora": True})
    ref.save(tmp_path / "ref.json")
    port = tcfg.Config.load(tmp_path / "ref.json")
    want = _plain(ref.to_dict())
    got = _plain(port.to_dict())
    assert set(got) == set(want)
    for block in want:
        assert set(got[block]) == set(want[block]), block
        for field, value in want[block].items():
            assert got[block][field] == value, (block, field)
    assert port.benchmarking.batch_sizes == (1, 2)  # tuples stay tuples


def test_port_saved_config_loads_into_the_reference(tmp_path):
    port = tcfg.default_config().override(**{
        "train.seq_len": 64, "optimization.attention_impl": "pallas",
        "distributed.pipe_microbatches": 3})
    port.save(tmp_path / "port.json")
    ref = jcfg.Config.load(tmp_path / "port.json")
    assert _plain(ref.to_dict()) == _plain(port.to_dict())


def test_config_defaults_overrides_and_unknown_keys():
    ours, ref = tcfg.default_config().to_dict(), jcfg.default_config() \
        .to_dict()
    # every default the reference's, but the hardware block: the port's
    # describes the card (gpu, 80 GB), the reference's a v5e chip
    assert {k: v for k, v in ours.items() if k != "hardware"} == \
        {k: v for k, v in ref.items() if k != "hardware"}
    assert ours["hardware"] == {"platform": "gpu", "chips_expected": 0,
                                "hbm_gb_per_chip": 80.0}
    cfg = tcfg.Config.from_dict({"train": {"epochs": 2, "future": 1},
                                 "nonsense": {}})
    assert cfg.train.epochs == 2
    assert cfg.override(**{"train.epochs": 5}).train.epochs == 5
    assert cfg.train.epochs == 2  # override copies
    with pytest.raises(AttributeError, match="no config field"):
        cfg.override(**{"train.nope": 1})


# ------------------------------------------------------- token files


def test_token_files_cross_between_the_packages(tmp_path):
    split = ttext.synthetic_lm_split(9, seq_len=12, vocab_size=500, seed=4)
    assert split.seq_len == 12
    ttext.save_token_file(split, tmp_path / "port.npz")
    back = jtext.load_token_file(tmp_path / "port.npz")
    ref = jtext.synthetic_lm_split(9, seq_len=12, vocab_size=500, seed=4)
    jtext.save_token_file(ref, tmp_path / "ref.npz")
    ours = ttext.load_token_file(tmp_path / "ref.npz")
    for a, b in ((back, split), (ours, ref)):
        assert a.seq_len == b.seq_len == 12
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)


# ------------------------------------------------------- drift guards


def test_tier_gated_is_the_references():
    assert thost.TIER_GATED == jhost.TIER_GATED
    table = {k: "higher" for k in thost.TIER_GATED[1:]}
    assert thost.ungated_tier_keys(table) == \
        jhost.ungated_tier_keys(table) == [thost.TIER_GATED[0]]


def _run_guard(root: Path, name: str):
    return subprocess.run([sys.executable, str(root / "scripts" / name)],
                          capture_output=True, text=True, cwd=root,
                          timeout=120)


@pytest.mark.parametrize("name", ["check_diff_gates_torch.py",
                                  "check_event_vocab_torch.py"])
def test_guard_passes_on_the_tree(name):
    proc = _run_guard(REPO, name)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def _copy(tmp_path: Path, name: str) -> Path:
    """The guard and the port's package in a scratch checkout."""
    root = tmp_path / "checkout"
    (root / "scripts").mkdir(parents=True)
    shutil.copy(REPO / "scripts" / name, root / "scripts" / name)
    shutil.copytree(REPO / "hyperion_tpu_torch", root / "hyperion_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _rename(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


def test_diff_guard_fails_on_a_renamed_serving_key(tmp_path):
    """loadgen's `ttft_p99_ms` renamed: the gate fed by it
    (serve_ttft_p99_ms) is orphaned."""
    root = _copy(tmp_path, "check_diff_gates_torch.py")
    _rename(root / "hyperion_tpu_torch" / "serve" / "loadgen.py",
            '"ttft_p50_ms", "ttft_p99_ms",', '"ttft_p50_ms", "ttft_p99",')
    proc = _run_guard(root, "check_diff_gates_torch.py")
    assert proc.returncode == 1
    assert "serve_ttft_p99_ms" in proc.stderr


def test_event_guard_fails_on_a_renamed_event(tmp_path):
    """The engine's `serve_warmup_done` renamed at its call site: no
    consumer knows the new name."""
    root = _copy(tmp_path, "check_event_vocab_torch.py")
    _rename(root / "hyperion_tpu_torch" / "serve" / "engine.py",
            'event("serve_warmup_done"', 'event("serve_warmup_finished"')
    proc = _run_guard(root, "check_event_vocab_torch.py")
    assert proc.returncode == 1
    assert "serve_warmup_finished" in proc.stderr
    assert "hyperion_tpu_torch/serve/engine.py:" in proc.stderr
