"""Paged attention at any head_dim, against the JAX package on the CPU.

The reference's kernel (`hyperion_tpu/ops/pallas/paged_attention.py`)
has no head_dim check: its blocks are (rows, D) and (bs, D) at any D.
The port runs every D on the card (D up to 256 on the instantiation at
the next multiple of 16, read at the true width; past 256 on the wide
kernel), and its plain version, which the CPU runs, is held here to the
JAX kernel in interpret mode at head dims no instantiation has: 8, 72,
100 (bf16 rows of 200 bytes), 264 and 320 (the wide kernel's two output
chunks), in decode, verify and chunk windows with GQA. fp32, within the
reference's own 2e-5 bound between its kernel and the gather read.

The slice as a whole: a tiny Llama at head_dim 72 (d_model 288, 4 heads,
2 KV heads) served greedily through the paged cache, the JAX model with
`paged_attn_impl="pallas"` (its kernel) against the port's paged
forward on weights crossed by `params_from_jax`: the token streams are
equal.

Inputs come from numpy seeds. Slowest (`--durations`, one CPU process):
the Llama stream, ~5 s (JAX's init and two compiles); each kernel
comparison under 1 s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.models import llama as jl
from hyperion_tpu.ops.pallas.paged_attention import (
    paged_attention as jax_paged_attention,
)
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.ops import paged_attention as pa_mod
from hyperion_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)

HEAD_DIMS = (8, 72, 100, 264, 320)
# GQA 4 over 2: decode, a [2, 5] verify window at ragged bases, and a
# [1, 12] chunk at a base no multiple of the block size
WINDOWS = {"decode": dict(B=3, T=1), "verify": dict(B=2, T=5),
           "chunk": dict(B=1, T=12, base=[9])}


def _geometry(B, T, D, H=4, Hkv=2, bs=4, MB=8, seed=0, base=None):
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    if base is None:
        base = rng.integers(0, MB * bs - T + 1, B)
    base = np.asarray(base, np.int32)
    bt = np.zeros((B, MB), np.int32)
    for b in range(B):
        n = (int(base[b]) + T + bs - 1) // bs
        bt[b, :n] = rng.permutation(np.arange(1, NB))[:n]
    return q, kp, vp, bt, base


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_plain_matches_jax_kernel_at_any_head_dim(window, D):
    q, kp, vp, bt, base = _geometry(D=D, seed=D, **WINDOWS[window])
    ref = np.asarray(jax_paged_attention(*(jnp.asarray(a) for a in
                                           (q, kp, vp, bt, base))))
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, base)]
    before = paged_attention.launches
    out = paged_attention(*args)
    assert paged_attention.launches == before  # the CPU runs no kernel
    assert torch.equal(out, paged_attention_plain(*args))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("D, Dk, chunks", [
    (1, 16, 1), (8, 16, 1), (72, 80, 1), (100, 112, 1), (256, 256, 1),
    (264, 264, 2), (320, 320, 2), (384, 384, 2), (512, 512, 3)])
def test_every_head_dim_plans(D, Dk, chunks):
    """`plan` takes every D >= 1: up to 256 one chunk on the next multiple
    of 16, past it the wide kernel's ceil(D / 192) output chunks, each a
    block of its own in grid x."""
    assert pa_mod.kernel_head_dim(D) == Dk
    for T in (1, 512):
        p = pa_mod.plan(4, T, 8, 2, D, 16, 64)
        assert p.chunks == chunks
        assert p.grid(4, 2)[0] == p.row_tiles * p.n_splits * chunks
    with pytest.raises(ValueError, match="head_dim >= 1"):
        pa_mod.plan(4, 1, 8, 2, 0, 16, 64)


def test_llama_at_head_dim_72_serves_the_jax_kernels_stream():
    """d_model 288 over 4 heads of 72 with 2 KV heads (one layer, which
    keeps JAX's two compiles short): a 9-token prompt
    prefilled into the paged cache, then 8 greedy decode steps, in each
    package; the JAX model reads its cache through its Pallas kernel."""
    kw = dict(vocab_size=256, d_model=288, n_heads=4, n_kv_heads=2,
              n_layers=1, ff_dim=256, max_len=32, norm_impl="pallas")
    jmodel = jl.Llama(jl.llama_tiny_config(paged_attn_impl="pallas", **kw))
    # jitted: eager flax init dispatches op by op
    params = jax.device_get(jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 8), jnp.int32))["params"])(jax.random.key(3)))
    cfg = tl.llama_tiny_config(paged_attn_impl="pallas", **kw)
    assert cfg.head_dim == 72
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    japply = jax.jit(jmodel.apply)
    bs, MB = 4, 5
    bt = np.arange(1, MB + 1, dtype=np.int32)[None]
    jcache = jl.init_paged_cache(jmodel.cfg, MB + 1, bs)
    tcache = tl.init_paged_cache(cfg, MB + 1, bs, device="cpu")
    prompt = np.random.default_rng(4).integers(1, 256, (1, 9))
    streams = {"jax": [], "port": []}
    ids, pos = prompt.astype(np.int32), 0
    jids = tids = ids
    for _ in range(8):
        idx = np.array([pos], np.int32)
        jlog, jcache = japply({"params": params}, jnp.asarray(jids),
                              cache=jcache, cache_index=jnp.asarray(idx),
                              block_tables=jnp.asarray(bt))
        with torch.no_grad():
            tlog, tcache = model(torch.from_numpy(tids), cache=tcache,
                                 cache_index=torch.from_numpy(idx),
                                 block_tables=torch.from_numpy(bt))
        pos += jids.shape[1]
        jnext = int(np.argmax(np.asarray(jlog)[0, -1]))
        tnext = int(tlog[0, -1].argmax())
        streams["jax"].append(jnext)
        streams["port"].append(tnext)
        jids = np.array([[jnext]], np.int32)
        tids = np.array([[tnext]], np.int32)
    assert streams["port"] == streams["jax"], streams
