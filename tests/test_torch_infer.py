"""The port's cache-free decoding and inference CLI
(`infer/generate.py` `generate_recompute`, `model_from_npz`, `main`;
`python -m hyperion_tpu_torch.infer`) against the JAX package's, on the
CPU.

At temperature 0 decoding is argmax all the way, so token streams are
held equal (no tolerance) between the packages on a tiny fp32
TransformerLM with the JAX init's weights, and the CLI's printed text
equals the JAX CLI's for the same export and tokenizer. A Llama export
decodes through `generate` (and with `--draft-ckpt` through the
speculative decode), and its text equals the port's in-process decode;
`generate_recompute` over a Llama equals its KV-cache `generate`.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.checkpoint.io import export_gathered
from hyperion_tpu.data.bpe import train_bpe
from hyperion_tpu.models import llama as jl
from hyperion_tpu.models import transformer_lm as jt
from hyperion_tpu_torch.checkpoint.io import load_gathered
from hyperion_tpu_torch.infer import generate as tgen
from hyperion_tpu_torch.models import transformer_lm as tt

# the module: the JAX package's `infer` exports the function `generate`
jgen = importlib.import_module("hyperion_tpu.infer.generate")
REPO = Path(__file__).resolve().parents[1]
CORPUS = ["the quick brown fox jumps over the lazy dog"] * 4
LM = dict(d_model=32, n_heads=4, n_layers=2, ff_dim=64, max_len=32,
          dropout=0.0)
PROMPT = "the quick brown"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tokenizer (at most 300 tokens: the corpus runs out of merges
    first), a TransformerLM export at its vocab, and tiny Llama target
    and draft exports."""
    d = tmp_path_factory.mktemp("infer")
    tok = train_bpe(CORPUS, vocab_size=300, verbose=False)
    tok.save(d / "tok")
    lm = jt.TransformerLM(jt.simple_lm_config(vocab_size=tok.vocab_size,
                                              **LM))
    export_gathered(d / "lm.npz", jax.device_get(
        jax.jit(lm.init_params)(jax.random.key(0))))
    for name, layers, seed in (("target", 2, 1), ("draft", 1, 2)):
        cfg = jl.llama_tiny_config(vocab_size=tok.vocab_size, max_len=64,
                                   n_layers=layers)
        export_gathered(d / f"{name}.npz", jax.device_get(jax.jit(
            lambda r: jl.Llama(cfg).init_params(r, seq=8))(
                jax.random.key(seed))))
    return d, tok


@pytest.mark.parametrize("eos", [None, 7])
def test_recompute_stream_equals_jax(files, eos):
    d, tok = files
    V = tok.vocab_size
    params = load_gathered(d / "lm.npz")
    model, cached = tgen.model_from_npz(params, device="cpu")
    assert not cached and model.cfg == tt.simple_lm_config(vocab_size=V,
                                                           **LM)
    jmodel = jt.TransformerLM(jt.simple_lm_config(vocab_size=V, **LM))
    prompts = np.random.default_rng(0).integers(1, V, (3, 5))
    want = jgen.generate_recompute(
        jmodel, {"params": jax.tree.map(jnp.asarray, params)},
        jnp.asarray(prompts, jnp.int32), 12, eos_id=eos, pad_id=0)
    got = tgen.generate_recompute(model, prompts, 12, eos_id=eos, pad_id=0,
                                  device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate_recompute(model, prompts, 28, device="cpu")


def test_recompute_equals_the_kv_cache_decode_on_llama(files):
    d, tok = files
    model, cached = tgen.model_from_npz(load_gathered(d / "target.npz"),
                                        max_len=64, dtype="float32",
                                        device="cpu")
    assert cached
    prompts = np.random.default_rng(1).integers(1, tok.vocab_size, (2, 6))
    np.testing.assert_array_equal(
        tgen.generate_recompute(model, prompts, 10, device="cpu").numpy(),
        tgen.generate(model, prompts, 10, device="cpu").numpy())


def _cli(argv, capsys, main):
    assert main(argv) == 0
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_cli_text_equals_the_jax_cli(files, capsys):
    d, _ = files
    argv = ["--prompt", PROMPT, "--ckpt", str(d / "lm.npz"),
            "--tokenizer-dir", str(d / "tok"), "--max-new-tokens", "8"]
    want = _cli(argv, capsys, jgen.main)
    got = _cli(argv + ["--device", "cpu"], capsys, tgen.main)
    assert got == want and got.startswith(PROMPT)


def test_cli_llama_and_speculative(files, capsys):
    """Llama exports decode through `generate` (bf16, the loader's
    default); `--draft-ckpt` through the speculative decode, whose
    greedy stream is the target's."""
    d, tok = files
    model, _ = tgen.model_from_npz(load_gathered(d / "target.npz"),
                                   max_len=64, device="cpu")
    ids = tgen.generate(model, [tok.encode(PROMPT + " fox jumps")], 6,
                        eos_id=tok.eos_id, pad_id=tok.eos_id, device="cpu")
    want = PROMPT + " fox jumps" + tok.decode(
        [int(t) for t in ids[0] if t != tok.eos_id])
    base = ["--prompt", PROMPT + " fox jumps", "--tokenizer-dir",
            str(d / "tok"), "--max-new-tokens", "6", "--max-len", "64",
            "--device", "cpu", "--ckpt", str(d / "target.npz")]
    assert _cli(base, capsys, tgen.main) == want
    assert _cli(base + ["--draft-ckpt", str(d / "draft.npz"), "--draft-k",
                        "3"], capsys, tgen.main) == want


def test_cli_llama_int8_equals_the_jax_cli(files, capsys):
    """`--quant int8` on a Llama export: the export's fp32 kernels
    quantized per output feature, decoded in bf16 through the int8
    product; the text equals the JAX CLI's, and with `--draft-ckpt` (the
    draft quantized too) the speculative decode prints the same."""
    d, _ = files
    base = ["--prompt", PROMPT + " fox jumps", "--tokenizer-dir",
            str(d / "tok"), "--max-new-tokens", "6", "--max-len", "64",
            "--ckpt", str(d / "target.npz"), "--quant", "int8"]
    want = _cli(base, capsys, jgen.main)
    assert _cli(base + ["--device", "cpu"], capsys, tgen.main) == want
    assert _cli(base + ["--device", "cpu", "--draft-ckpt",
                        str(d / "draft.npz"), "--draft-k", "3"],
                capsys, tgen.main) == want


def test_moe_exports_and_int8_name_their_items(files, tmp_path, capsys):
    """An MoE LM export decodes through `generate_recompute`, its routing
    top_k given by `--moe-top-k` (not in the weights): the CLI's text
    equals the JAX CLI's. A pipeline export raises as the reference's
    does. `--quant int8` decodes a TransformerLM export through the
    int8 model, its text equal to the JAX CLI's `--quant int8`, and
    refuses an MoE export with the reference's message."""
    from hyperion_tpu.models import moe_lm as jm
    from hyperion_tpu.ops.moe import MoEConfig
    from hyperion_tpu_torch.models.moe_lm import MoELM

    d, tok = files
    base = jt.simple_lm_config(vocab_size=tok.vocab_size, **LM)
    jmodel = jm.MoELM(jm.MoELMConfig(base=base, moe=MoEConfig(
        n_experts=4, top_k=2, d_model=32, ff_dim=64,
        activation=base.activation)))
    export_gathered(tmp_path / "moe.npz", jax.device_get(
        jax.jit(jmodel.init_params)(jax.random.key(3))))
    model, cached = tgen.model_from_npz(load_gathered(tmp_path / "moe.npz"),
                                        device="cpu", moe_top_k=2)
    assert isinstance(model, MoELM) and not cached
    assert (model.moe_cfg.moe_every, model.moe_cfg.moe.n_experts) == (2, 4)
    argv = ["--prompt", PROMPT, "--ckpt", str(tmp_path / "moe.npz"),
            "--tokenizer-dir", str(d / "tok"), "--max-new-tokens", "8",
            "--moe-top-k", "2"]
    want = _cli(argv, capsys, jgen.main)
    assert _cli(argv + ["--device", "cpu"], capsys, tgen.main) == want
    with pytest.raises(ValueError, match="pipeline checkpoints"):
        tgen.model_from_npz({"stages": {}, "tok_emb": {}}, device="cpu")
    int8 = ["--prompt", PROMPT, "--ckpt", str(d / "lm.npz"),
            "--tokenizer-dir", str(d / "tok"), "--max-new-tokens", "8",
            "--quant", "int8"]
    want = _cli(int8, capsys, jgen.main)
    assert _cli(int8 + ["--device", "cpu"], capsys, tgen.main) == want
    moe_int8 = argv + ["--quant", "int8", "--device", "cpu"]
    moe_int8[moe_int8.index("--ckpt") + 1] = str(tmp_path / "moe.npz")
    with pytest.raises(SystemExit, match="MoE expert banks"):
        tgen.main(moe_int8)


def test_module_entry_point_runs_on_the_cpu_when_asked(files):
    """`python -m hyperion_tpu_torch.infer`: with no card it refuses
    the default device and runs with `--device cpu`."""
    d, _ = files
    argv = [sys.executable, "-m", "hyperion_tpu_torch.infer", "--prompt",
            PROMPT, "--ckpt", str(d / "lm.npz"), "--tokenizer-dir",
            str(d / "tok"), "--max-new-tokens", "4"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    if not torch.cuda.is_available():
        run = subprocess.run(argv, capture_output=True, text=True, env=env,
                             timeout=120)
        assert run.returncode != 0 and "device=\"cpu\"" in run.stderr
    run = subprocess.run(argv + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().startswith(PROMPT)
