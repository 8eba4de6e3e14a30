"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the gradients through them against the plain versions'
autograd. jax-free, so it runs where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which the card's
machine does not have.) Without a CUDA device every test skips with
its reason. chip_smoke.py holds the same kernels at full model width;
these cover the small, odd geometries: GQA, a shared prefix, a window
running past the table, head dims from 16 to 256, the paged kernel's
plans (chains split across blocks, with rows that end inside, on and at
the end of a split; prefill row tiles at base 0 and mid-block), its
determinism and null-block poison, odd rows and
widths, the three RMSNorm forward kernels and both backward kernels (a
warp a row up to 1024 wide, a block a row past that, scalar loads for
odd widths and misaligned views; dx with and without dw, reruns
bit-identical), both LayerNorm kernels (a warp a row up to 1024 wide, a block a
row past that, for odd widths and misaligned views), the widest
LayerNorm row (64 KB of shared memory), a ragged
vocab and the strided [B, T-1, V] logits view (at an odd vocab its rows
sit off the contiguous output's 16-byte grid), the loss entry's
gradient of the whole [B, T, V] logits (odd and multiple-of-8 vocabs,
a base one element off the grid), flash head dims 32 to
128 (in bf16 48 zero-padded to 64, 80 and 96 to 128), a ragged
sequence, unequal query and key lengths,
the Hopper kernels' edges at D 64 and 128 (a sequence shorter than one
tile, causal with unequal lengths, a padding tail per row, a row all
padding) and the backward's determinism; and the trainer's host-side
paths on the card: an async train-state save against the in-place
optimizer steps launched right behind it, and a prefetched epoch
against `depth=0`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.ops.fused_ce import (
    fused_softmax_xent,
    fused_softmax_xent_bwd,
    fused_softmax_xent_bwd_plain,
    fused_softmax_xent_fwd,
    fused_softmax_xent_plain,
    fused_softmax_xent_shifted,
)
from hyperion_tpu_torch.ops import flash_attention as fa
from hyperion_tpu_torch.ops import fused_norm as fn_mod
from hyperion_tpu_torch.ops.fused_norm import (
    fused_layernorm,
    fused_layernorm_plain,
    fused_rmsnorm,
    fused_rmsnorm_bwd,
    fused_rmsnorm_bwd_plain,
    fused_rmsnorm_plain,
    layernorm_path,
    rmsnorm_bwd_path,
    rmsnorm_path,
)
from hyperion_tpu_torch.ops import paged_attention as pa_mod
from hyperion_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)

pytestmark = pytest.mark.cuda
# (atol, rtol). bf16: both sides compute in fp32 and round once, so they
# may differ by one bf16 ulp, at most 2**-7 of the value.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-3, 2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _geometry(dev, dtype, B, T, H, Hkv, D, bs=4, MB=8, seed=0,
              share_prefix=False, full=False, base=None):
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    q, kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for shape in
        ((B, T, H, D), (NB, bs, Hkv, D), (NB, bs, Hkv, D)))
    # full: the window runs to the table's end (bucket padding past it)
    if base is None:
        base = (np.full(B, MB * bs - T // 2) if full
                else rng.integers(0, MB * bs - T + 1, B))
    base = np.asarray(base).astype(np.int32)
    bt = np.zeros((B, MB), np.int32)
    for b in range(B):
        n = min(MB, (int(base[b]) + T + bs - 1) // bs)
        bt[b, :n] = rng.permutation(np.arange(1, NB))[:n]
    if share_prefix:
        bt[:, 0] = bt[0, 0]
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(base).to(dev))


# The kernel's plan (ops/paged_attention.py `plan`) splits a chain of
# MB * bs positions across blocks for windows of at most 16 query rows
# and takes 64-row tiles past that: the cases at bs 16 and MB 16-64 run
# many splits (decode, verify) or several row tiles (prefill), at every
# kind of head dim the kernel takes (16 to 256 in steps of 16).
CASES = {
    "decode": dict(B=3, T=1, H=4, Hkv=4, D=64),
    "verify_gqa": dict(B=2, T=5, H=8, Hkv=2, D=128, seed=1),
    "prefill": dict(B=1, T=24, H=4, Hkv=4, D=32, seed=2),
    "shared_prefix": dict(B=3, T=2, H=4, Hkv=4, D=256, seed=3,
                          share_prefix=True),
    "past_the_table": dict(B=2, T=6, H=4, Hkv=1, D=96, seed=4, full=True),
    "decode_d16_splits": dict(B=3, T=1, H=4, Hkv=2, D=16, bs=16, MB=64,
                              seed=6),
    "verify_d80_splits": dict(B=2, T=5, H=8, Hkv=8, D=80, bs=16, MB=64,
                              seed=7),
    "decode_d256_splits": dict(B=2, T=1, H=4, Hkv=4, D=256, bs=16, MB=32,
                               seed=8),
    "prefill_d80_base0": dict(B=1, T=100, H=4, Hkv=2, D=80, bs=16, MB=16,
                              seed=9, base=[0]),
    "prefill_d16_base37": dict(B=1, T=90, H=4, Hkv=4, D=16, bs=16, MB=16,
                               seed=10, base=[37]),
    "decode_70b_heads": dict(B=2, T=1, H=64, Hkv=8, D=128, bs=16, MB=32,
                             seed=11),
    "prefill_70b_heads": dict(B=1, T=40, H=64, Hkv=8, D=128, bs=16, MB=8,
                              seed=12, base=[3]),
    # decode rows over 32-position splits: a visible length shorter than
    # one split, one ending exactly on a split boundary, the whole table
    "split_edges": dict(B=3, T=1, H=4, Hkv=4, D=64, bs=16, MB=64, seed=13,
                        base=[5, 63, 1023]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_attention_matches_plain(cuda, case, dtype):
    q, kp, vp, bt, base = _geometry(cuda, dtype, **CASES[case])
    if case == "split_edges":
        assert pa_mod.plan_for(q, kp, bt).split_len == 32
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, bt, base)
    assert paged_attention.launches == before + 1
    ref = paged_attention_plain(q, kp, vp, bt, base)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_paged_attention_null_block_poison(cuda):
    q, kp, vp, bt, base = _geometry(cuda, torch.float32, 3, 2, 4, 4, 64,
                                    seed=5)
    clean = paged_attention(q, kp, vp, bt, base)
    kp[0], vp[0] = 1e4, -1e4
    assert torch.equal(paged_attention(q, kp, vp, bt, base), clean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["decode_d16_splits", "verify_d80_splits",
                                  "prefill_d80_base0"])
def test_paged_attention_splits_are_deterministic_and_poison_free(
        cuda, case, dtype):
    """Two runs give the same bits (the splits merge in a fixed order, no
    atomics), and garbage in the null block behind unmapped table entries
    changes no bit: splits past a row's frontier read no K/V."""
    q, kp, vp, bt, base = _geometry(cuda, dtype, **CASES[case])
    assert int((bt == 0).sum()) > 0
    runs = [paged_attention(q, kp, vp, bt, base) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    kp[0], vp[0] = 1e4, -1e4
    assert torch.equal(paged_attention(q, kp, vp, bt, base), runs[0])


def test_paged_attention_kernels_keep_to_registers(cuda):
    """The split kernel at 7B's decode tick and prefill plans, and the
    combine, spill nothing to local memory and fit a block's shared
    memory."""
    for T in (1, 512):
        p = pa_mod.plan(4, T, 32, 32, 128, 16, 64)
        for dtype in (torch.bfloat16, torch.float32):
            for which in ("split", "combine"):
                attrs = pa_mod.kernel_attrs(128, dtype, p, which)
                assert attrs["spill_bytes"] == 0, (T, dtype, which, attrs)
                assert attrs["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 7, 4096), (5, 96), (2, 16384)])
def test_rmsnorm_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    out = fused_rmsnorm(x, w)
    ref = fused_rmsnorm_plain(x, w)
    if dtype == torch.bfloat16:
        ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int())
        assert int(ulps.abs().max()) <= 1
    else:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_rmsnorm_grads_equal_plain_grads(cuda):
    """The gradient through the kernels (forward, then the backward
    kernel) against autograd of the plain version: dx within the
    forward's tolerances (one bf16 ulp; 2e-5 in fp32), dw (fp32) within
    2e-5 — the two sum in other orders."""
    g = torch.Generator(device=cuda).manual_seed(40)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(6, 512, generator=g, device=cuda).to(dtype)
        w = 1.0 + 0.1 * torch.randn(512, generator=g, device=cuda)
        gy = torch.randn(6, 512, generator=g, device=cuda).to(dtype)
        grads = []
        for fn in (fused_rmsnorm, fused_rmsnorm_plain):
            xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
            before = fused_rmsnorm.launches, fused_rmsnorm_bwd.launches
            fn(xs, ws).backward(gy)
            kernel = fn is fused_rmsnorm
            assert (fused_rmsnorm.launches, fused_rmsnorm_bwd.launches) == (
                before[0] + kernel, before[1] + kernel)
            grads.append((xs.grad, ws.grad))
        (dx, dw), (ref_dx, ref_dw) = grads
        if dtype == torch.bfloat16:
            assert _ulps(dx, ref_dx) <= 1
        else:
            torch.testing.assert_close(dx, ref_dx, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(dw, ref_dw, atol=2e-5, rtol=2e-5)


def _rms_inputs(dev, dtype, rows, d, offset, seed):
    """x and g [rows, d] at `offset` elements into flat buffers (off the
    16-byte grid for an offset of 1), and a weight."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ts = []
    for _ in range(2):
        flat = torch.empty(rows * d + offset, device=dev, dtype=dtype)
        t = flat[offset:].view(rows, d)
        t.copy_(torch.randn(rows, d, generator=gen, device=dev))
        ts.append(t)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    return ts[0], w, ts[1]


def _rms_close(out, ref):
    if out.dtype == torch.bfloat16:
        assert _ulps(out, ref) <= 1
    else:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def _rms_dx_close(dx, ref):
    """dx within one bf16 ulp, at least 2**-16 absolute (where r w g and
    x r^3 S / d cancel, the two sides' sums in other orders differ by
    more than a tiny dx's own ulp), or 2e-5 in fp32."""
    if dx.dtype != torch.bfloat16:
        return _rms_close(dx, ref)
    ulps = (dx.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    near_zero = (dx.float() - ref.float()).abs() <= 2.0 ** -16
    assert bool(((ulps <= 1) | near_zero).all())


RMS_PATHS = {  # id: (d, offset, forward kernel, backward kernel)
    "8": (8, 0, "warp", "vector"),
    "256": (256, 0, "warp", "vector"),
    "1024": (1024, 0, "warp", "vector"),
    "1032": (1032, 0, "block", "vector"),
    "4096": (4096, 0, "block", "vector"),
    "16384": (16384, 0, "block", "vector"),
    "102": (102, 0, "scalar", "scalar"),
    "4096_misaligned": (4096, 1, "scalar", "scalar"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(RMS_PATHS))
def test_rmsnorm_paths(cuda, case, dtype):
    """Each width and alignment takes the forward kernel its rule names
    and matches the plain version, one launch a call."""
    d, offset, path, _ = RMS_PATHS[case]
    x, w, _ = _rms_inputs(cuda, dtype, 37, d, offset, d + offset)
    assert rmsnorm_path(x, w) == path
    before = fused_rmsnorm.launches
    out = fused_rmsnorm(x, w)
    assert fused_rmsnorm.launches == before + 1
    _rms_close(out, fused_rmsnorm_plain(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("need", ["dx", "dx_dw", "dw"])
@pytest.mark.parametrize("case", list(RMS_PATHS))
def test_rmsnorm_bwd_matches_plain(cuda, case, need, dtype):
    """The backward kernel against `fused_rmsnorm_bwd_plain`: dx as
    `_rms_dx_close`; dw (fp32) within 4 sqrt(rows)
    2**-24 max|dw| of sums over rows taken in another order. 1100 rows
    put more than one row in each dw block. One launch a call, reruns
    bit-identical."""
    d, offset, _, path = RMS_PATHS[case]
    rows = 1100 if d <= 4096 else 37
    x, w, g = _rms_inputs(cuda, dtype, rows, d, offset, 7 * d + offset)
    assert rmsnorm_bwd_path(x, w, g) == path
    need_dx, need_dw = "dx" in need, "dw" in need
    before = fused_rmsnorm_bwd.launches
    dx, dw = fused_rmsnorm_bwd(x, w, g, need_dx=need_dx, need_dw=need_dw)
    assert fused_rmsnorm_bwd.launches == before + 1
    again = fused_rmsnorm_bwd(x, w, g, need_dx=need_dx, need_dw=need_dw)
    ref_dx, ref_dw = fused_rmsnorm_bwd_plain(x, w, g)
    assert (dx is None) == (not need_dx) and (dw is None) == (not need_dw)
    if need_dx:
        assert torch.equal(dx, again[0])
        _rms_dx_close(dx, ref_dx)
    if need_dw:
        assert torch.equal(dw, again[1])
        tol = 4 * rows ** 0.5 * 2.0 ** -24 * float(ref_dw.abs().max())
        torch.testing.assert_close(dw, ref_dw, atol=tol, rtol=0)


def test_rmsnorm_backward_runs_no_eager_vjp(cuda, monkeypatch):
    """On the card the RMSNorm gradient is the backward kernel alone:
    `_vjp_of` (LayerNorm's eager VJP) is never called, and a strided
    cotangent is made contiguous first."""
    def refuse(*a, **k):
        raise AssertionError("_vjp_of called for RMSNorm")

    monkeypatch.setattr(fn_mod, "_vjp_of", refuse)
    x, w, g = _rms_inputs(cuda, torch.bfloat16, 64, 4096, 0, 3)
    xs = x.clone().requires_grad_()
    g_strided = torch.stack([g, g], dim=-1)[..., 0]  # g's values, stride 2
    before = fused_rmsnorm_bwd.launches
    fused_rmsnorm(xs, w).backward(g_strided)
    assert fused_rmsnorm_bwd.launches == before + 1
    ref_dx, _ = fused_rmsnorm_bwd_plain(x, w, g_strided)
    assert torch.equal(xs.grad, fused_rmsnorm_bwd(x, w, g, need_dw=False)[0])
    _rms_dx_close(xs.grad, ref_dx)


def test_paged_attention_refuses_grad(cuda):
    q, kp, vp, bt, base = _geometry(cuda, torch.float32, 2, 1, 4, 4, 32)
    before = paged_attention.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        paged_attention(q.requires_grad_(), kp, vp, bt, base)
    assert paged_attention.launches == before
    with torch.no_grad():
        paged_attention(q, kp, vp, bt, base)
    assert paged_attention.launches == before + 1


def _ulps(a, b):
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("shape", [(3, 7, 256), (5, 96), (1, 33), (2, 16384)])
def test_layernorm_matches_plain(cuda, shape, residual, dtype):
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + residual)
    x = (torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype)
    r = torch.randn(shape, generator=g, device=cuda).to(dtype) \
        if residual else None
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    b = 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    before = fused_layernorm.launches
    out = fused_layernorm(x, w, b, residual=r, eps=1e-6)
    assert fused_layernorm.launches == before + 1
    ref = fused_layernorm_plain(x, w, b, residual=r, eps=1e-6)
    if dtype == torch.bfloat16:
        # one ulp, taken at no less than 2**-8: where `* w + b` cancels
        # towards zero the sides' fp32 statistics (summed in other
        # orders) differ by more than the tiny output's own ulp
        ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int())
        near_zero = (out.float() - ref.float()).abs() <= 2.0 ** -16
        assert bool(((ulps.abs() <= 1) | near_zero).all())
    else:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d, offset, path", [
    (256, 0, "warp"), (768, 0, "warp"), (1024, 0, "warp"), (8, 0, "warp"),
    (1032, 0, "block"), (102, 0, "block"), (256, 1, "block")],
    ids=["256", "768", "1024", "8", "1032", "102", "256_misaligned"])
def test_layernorm_paths(cuda, d, offset, path, dtype):
    """Each width and alignment takes the kernel its rule names and
    matches the plain version: the warp kernel for rows of whole 16-byte
    chunks up to 1024 wide, the block kernel past that, for a width of
    no whole chunk (102), and for a view `offset` elements into a flat
    buffer, off the 16-byte grid."""
    g = torch.Generator(device=cuda).manual_seed(d + offset)
    rows = 37
    flat = torch.empty(rows * d + offset, device=cuda, dtype=dtype)
    x = flat[offset:].view(rows, d)
    x.copy_(torch.randn(rows, d, generator=g, device=cuda) + 0.5)
    r = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    w = 1.0 + 0.1 * torch.randn(d, generator=g, device=cuda)
    b = 0.1 * torch.randn(d, generator=g, device=cuda)
    for res in (None, r):
        assert layernorm_path(x, w, b, residual=res) == path
        out = fused_layernorm(x, w, b, residual=res, eps=1e-6)
        ref = fused_layernorm_plain(x, w, b, residual=res, eps=1e-6)
        if dtype == torch.bfloat16:
            ulps = (out.view(torch.int16).int()
                    - ref.view(torch.int16).int())
            near_zero = (out.float() - ref.float()).abs() <= 2.0 ** -16
            assert bool(((ulps.abs() <= 1) | near_zero).all())
        else:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_layernorm_grads_equal_plain_grads(cuda):
    g = torch.Generator(device=cuda).manual_seed(41)
    for dtype in (torch.float32, torch.bfloat16):
        x, r, gy = (torch.randn(8, 256, generator=g, device=cuda).to(dtype)
                    for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(256, generator=g, device=cuda)
        b = 0.1 * torch.randn(256, generator=g, device=cuda)
        grads = []
        for fn in (fused_layernorm, fused_layernorm_plain):
            ts = [t.clone().requires_grad_() for t in (x, r, w, b)]
            fn(ts[0], ts[2], ts[3], residual=ts[1], eps=1e-6).backward(gy)
            grads.append([t.grad for t in ts])
        for a, c in zip(*grads):
            torch.testing.assert_close(a, c, atol=0, rtol=0)


def _ce_inputs(dev, dtype, shape, seed, strided=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    *rows, V = shape
    if strided:  # the [B, T-1, V] view of [B, T, V] logits
        full = 3 * torch.randn(rows[0], rows[1] + 1, V, generator=g,
                               device=dev)
        logits = full.to(dtype)[:, :-1]
    else:
        logits = (3 * torch.randn(shape, generator=g, device=dev)).to(dtype)
    targets = torch.randint(0, V, tuple(rows), generator=g, device=dev)
    return logits, targets


# dlogits are held to 1e-6 of each element's own size, down to fp32's
# smallest normal: most elements are far below an absolute 1e-6
FP32_TINY = torch.finfo(torch.float32).tiny
CE_CASES = {"ragged_37x5003": ((37, 5003), False),
            "strided_3x6x1000": ((3, 6, 1000), True),
            # rows of the view and of the contiguous output off the
            # 16-byte grid by different amounts: the scalar row loop
            "strided_3x6x5003": ((3, 6, 5003), True),
            "one_row_7": ((1, 7), False)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_softmax_xent_matches_plain(cuda, case, dtype):
    shape, strided = CE_CASES[case]
    logits, targets = _ce_inputs(cuda, dtype, shape, 42, strided)
    before = (fused_softmax_xent_fwd.launches, fused_softmax_xent_bwd.launches)
    loss, lse = fused_softmax_xent_fwd(logits, targets)
    ref_loss, ref_lse = fused_softmax_xent_fwd(logits.cpu(), targets.cpu())
    torch.testing.assert_close(loss.cpu(), ref_loss, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(lse.cpu(), ref_lse, atol=1e-6, rtol=1e-5)
    gy = torch.rand(loss.shape, device=cuda)
    d = fused_softmax_xent_bwd(logits, targets, lse, gy)
    ref_d = fused_softmax_xent_bwd_plain(logits, targets, lse, gy)
    assert d.dtype == dtype and d.shape == logits.shape
    if dtype == torch.bfloat16:
        assert _ulps(d, ref_d) <= 1
    else:
        torch.testing.assert_close(d, ref_d, atol=FP32_TINY, rtol=1e-6)
    assert (fused_softmax_xent_fwd.launches,
            fused_softmax_xent_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_softmax_xent_autograd_runs_both_kernels(cuda):
    logits, targets = _ce_inputs(cuda, torch.float32, (4, 9, 300), 43, True)
    leaf = logits.detach().clone().requires_grad_()
    view = leaf[:, :-1]
    targets = targets[:, :-1]
    before = (fused_softmax_xent_fwd.launches, fused_softmax_xent_bwd.launches)
    fused_softmax_xent(view, targets).mean().backward()
    assert (fused_softmax_xent_fwd.launches,
            fused_softmax_xent_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = leaf.detach().clone().requires_grad_()
    fused_softmax_xent_plain(ref[:, :-1], targets).mean().backward()
    torch.testing.assert_close(leaf.grad, ref.grad, atol=FP32_TINY, rtol=1e-6)
    with torch.no_grad():
        fused_softmax_xent(view, targets)
    assert fused_softmax_xent_bwd.launches == before[1] + 1
    assert fused_softmax_xent_fwd.launches == before[0] + 2


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("V", [5003, 1000, 32000])
def test_softmax_xent_shifted_matches_plain(cuda, V, dtype, offset):
    """The loss entry over the whole [B, T, V] logits: its losses against
    the plain forward on the view; its gradient, the whole tensor,
    against the plain backward from the kernel's own lse (the kernel's
    tolerance) and against the plain version's autograd through the
    view, whose own lse may differ from the kernel's by the forward's
    error: exp(x - lse) carries that difference as a relative error, and
    x - lse rounds on each side to within 2**-24 of its size, so fp32
    adds the largest lse difference and 2**-23 of the largest |x - lse|
    to 1e-6. Row T-1 exactly zero,
    reruns bit-identical, one launch of each kernel a step. `offset`
    puts the logits one element off the 16-byte grid, so every row runs
    the scalar head and tail beside the 16-byte body."""
    B, T = 2, 7
    g = torch.Generator(device=cuda).manual_seed(45)
    buf = torch.empty(B * T * V + 8, device=cuda, dtype=dtype)
    logits = buf[offset:offset + B * T * V].view(B, T, V)
    logits.copy_(3 * torch.randn(B, T, V, generator=g, device=cuda))
    targets = torch.randint(0, V, (B, T - 1), generator=g, device=cuda)
    gy = torch.rand(B, T - 1, generator=g, device=cuda) / (B * T)
    grads = []
    for _ in range(2):
        leaf = logits.detach().requires_grad_()
        before = (fused_softmax_xent_fwd.launches,
                  fused_softmax_xent_bwd.launches)
        loss = fused_softmax_xent_shifted(leaf, targets)
        loss.backward(gy)
        assert (fused_softmax_xent_fwd.launches,
                fused_softmax_xent_bwd.launches) == (before[0] + 1,
                                                     before[1] + 1)
        grads.append(leaf.grad)
    d = grads[0]
    assert torch.equal(grads[0], grads[1])
    assert d.shape == logits.shape and d.dtype == dtype
    assert not d[:, -1].any()
    view = logits[:, :-1]
    ref_loss, ref_lse = fused_softmax_xent_fwd(view.cpu(), targets.cpu())
    torch.testing.assert_close(loss.detach().cpu(), ref_loss, atol=1e-6,
                               rtol=1e-5)
    _, lse = fused_softmax_xent_fwd(view, targets)
    ref_d = torch.zeros_like(d)
    ref_d[:, :-1] = fused_softmax_xent_bwd_plain(view, targets, lse, gy)
    ref = logits.detach().clone().requires_grad_()
    fused_softmax_xent_plain(ref[:, :-1], targets).backward(gy)
    if dtype == torch.bfloat16:
        assert _ulps(d, ref_d) <= 1
        assert _ulps(d, ref.grad) <= 1
    else:
        torch.testing.assert_close(d, ref_d, atol=FP32_TINY, rtol=1e-6)
        dlse = float((lse.cpu() - ref_lse).abs().max())
        spread = float((view - lse.unsqueeze(-1)).abs().max())
        torch.testing.assert_close(d, ref.grad, atol=FP32_TINY,
                                   rtol=1e-6 + dlse + 2.0 ** -23 * spread)


def test_softmax_xent_refuses_out_of_range_targets(cuda):
    logits, targets = _ce_inputs(cuda, torch.float32, (4, 50), 44)
    targets[1] = 50
    before = fused_softmax_xent_fwd.launches
    with pytest.raises(ValueError, match="must lie in"):
        fused_softmax_xent_fwd(logits, targets)
    assert fused_softmax_xent_fwd.launches == before


# flash attention: (B, Tq, Tkv, H, D, causal, padded fraction of keys —
# one for every row, or one per row; 1.0 pads the whole row). bf16 runs
# the Hopper kernels at D 64 and 128: T = 200 is no multiple of their 64-
# or 128-row tiles, T = 40 is shorter than one tile, causal Tq != Tkv both
# ways, two rows with different padding tails, and a row whose keys are
# all padding: every s is NEG_INF, so its o is the mean of v over the Tkv
# keys. Not causal: a causal kernel skips the tiles past a row's frontier
# (the reference's does too), so such a row's o depends on the tiling.
FLASH_CASES = {"causal_pad_d128": (2, 192, 192, 2, 128, True, 0.25),
               "all_pad_row_d128": (2, 200, 200, 2, 128, False, (1.0, 0.1)),
               "all_pad_row_cross_d128": (2, 70, 200, 2, 128, False,
                                          (0.2, 1.0)),
               "full_d64": (2, 130, 130, 3, 64, False, 0.0),
               "ragged_causal_d32": (1, 77, 77, 2, 32, True, 0.1),
               "cross_lengths_d64": (2, 70, 130, 2, 64, False, 0.2),
               "ragged_200_d128": (1, 200, 200, 2, 128, True, 0.25),
               "short_40_d128": (1, 40, 40, 2, 128, True, 0.0),
               "cross_causal_d128": (2, 70, 200, 2, 128, True, 0.2),
               "cross_causal_long_q_d128": (1, 200, 130, 2, 128, True, 0.1),
               "two_tails_d128": (2, 256, 256, 2, 128, True, (0.25, 0.1)),
               # D 80 and 96 run zero-padded to the D 128 kernels
               "causal_pad_d96": (2, 192, 192, 2, 96, True, 0.25),
               "cross_causal_d80": (2, 70, 200, 2, 80, True, 0.2),
               # the D 64 Hopper kernels' edges; D 48 runs zero-padded
               # to them in bf16
               "causal_pad_d64": (2, 192, 192, 2, 64, True, 0.25),
               "two_tails_d64": (2, 256, 256, 2, 64, True, (0.25, 0.1)),
               "ragged_200_d64": (1, 200, 200, 2, 64, True, 0.25),
               "all_pad_row_d64": (2, 200, 200, 2, 64, False, (1.0, 0.1)),
               "cross_causal_d64": (2, 70, 200, 2, 64, True, 0.2),
               "causal_pad_d48": (2, 192, 192, 2, 48, True, 0.25),
               # q scaled by 4 (FLASH_Q_SCALE): large logits, where a
               # TF32 term the fp32 kernels lost would show
               "scaled_q_d128": (2, 192, 192, 2, 128, True, 0.25)}
FLASH_Q_SCALE = {"scaled_q_d128": 4.0}


def _flash_inputs(dev, dtype, case, seed=45):
    B, Tq, Tkv, H, D, causal, padded = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q, o_g = (torch.randn(B, Tq, H, D, generator=g, device=dev)
              for _ in range(2))
    q, o_g = (q * FLASH_Q_SCALE.get(case, 1.0)).to(dtype), o_g.to(dtype)
    k, v = (torch.randn(B, Tkv, H, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    pad = None
    if padded:
        tails = padded if isinstance(padded, tuple) else (padded,) * B
        pad = torch.ones(B, Tkv, dtype=torch.int8, device=dev)
        for row, tail in enumerate(tails):
            pad[row, int(Tkv * (1 - tail)):] = 0
    return q, k, v, o_g, pad, causal


def _flash_close(out, ref, dtype, what):
    """fp32: 2e-5 for o and lse, 2e-4 for gradients (the reference's own
    kernel bounds). bf16 o: the kernel rounds p to bf16 per key tile
    against the running max, the plain version once against the row's
    max: one ulp of p (2^-8) over |v| <= 4 plus one of the output. bf16
    gradients: the same rounded ds and p, summed in another order, then
    rounded: 2^-6 of the largest gradient."""
    out, ref = out.float(), ref.float()
    if dtype == torch.float32 or what == "lse":
        tol = 2e-5 if what in ("o", "lse") else 2e-4
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    elif what == "o":
        assert ((out - ref).abs() <= 2.0 ** -6 + 2.0 ** -7 * ref.abs()).all()
    else:
        assert (out - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, case, dtype):
    q, k, v, g, pad, causal = _flash_inputs(cuda, dtype, case)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, padding_mask=pad)
    ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                  padding_mask=pad)
    _flash_close(o, ref_o, dtype, "o")
    _flash_close(lse, ref_lse, dtype, "lse")
    dq = fa.flash_attention_dq(q, k, v, o, lse, g, causal=causal,
                               padding_mask=pad)
    dk, dv = fa.flash_attention_dkv(q, k, v, o, lse, g, causal=causal,
                                    padding_mask=pad)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, causal=causal,
                                        padding_mask=pad)
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert out.dtype == dtype and out.shape == ref.shape
        _flash_close(out, ref, dtype, name)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(b + 1 for b in before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["causal_pad_d128", "two_tails_d128",
                                  "cross_causal_d128", "ragged_causal_d32",
                                  "causal_pad_d96", "causal_pad_d64",
                                  "two_tails_d64"])
def test_flash_backward_is_deterministic(cuda, case, dtype):
    """Two runs of the whole backward (one delta for both kernels, which
    the dq kernel computes) give the same bits, and match the plain
    backward. No gradient row has two writers."""
    q, k, v, g, pad, causal = _flash_inputs(cuda, dtype, case, seed=47)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, padding_mask=pad)
    runs = [fa.flash_attention_bwd(q, k, v, o, lse, g, causal=causal,
                                   padding_mask=pad) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, causal=causal,
                                        padding_mask=pad)
    for name, out, ref in zip(("dq", "dk", "dv"), runs[0], refs):
        _flash_close(out, ref, dtype, name)


def test_flash_hopper_backward_keeps_to_registers(cuda):
    """The bf16 D 128 backward kernels are the warp-specialised ones (three
    warpgroups) and spill nothing to local memory."""
    for which in ("dq", "dkv"):
        attrs = fa.kernel_attrs(which, 128, torch.bfloat16)
        assert attrs["threads"] == 384 and attrs["spill_bytes"] == 0, attrs
        assert attrs["smem_bytes"] <= 227 * 1024


def test_flash_hopper_forward_keeps_to_registers(cuda):
    """The bf16 forward, dq and dk/dv at D 64 and 128 are the
    warp-specialised kernels (three warpgroups), spill nothing to local
    memory and fit one block's shared memory. The fp32 forward, dq and
    dk/dv are the split-TF32 kernels (8 warps) at every kernel head dim,
    none spilling, each within 227 KB."""
    for D in fa.HEAD_DIMS[torch.bfloat16]:
        for which in ("fwd", "dq", "dkv"):
            attrs = fa.kernel_attrs(which, D, torch.bfloat16)
            assert attrs["threads"] == 384 and attrs["spill_bytes"] == 0, \
                (which, D, attrs)
            assert attrs["smem_bytes"] <= 227 * 1024
    for D in fa.HEAD_DIMS[torch.float32]:
        for which in ("fwd", "dq", "dkv"):
            attrs = fa.kernel_attrs(which, D, torch.float32)
            assert attrs["threads"] == 256 and attrs["spill_bytes"] == 0, \
                (which, D, attrs)
            assert attrs["smem_bytes"] <= 227 * 1024


def test_flash_autograd_runs_the_three_kernels(cuda):
    q, k, v, g, pad, causal = _flash_inputs(cuda, torch.float32,
                                            "causal_pad_d128", seed=46)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    o = fa.flash_attention(*leaves, causal=causal, padding_mask=pad)
    o.backward(g)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(b + 1 for b in before)
    plain = [t.clone().cpu().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*plain, causal=causal,
                       padding_mask=pad.cpu()).backward(g.cpu())
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=2e-4, rtol=2e-4)
    with torch.no_grad():
        fa.flash_attention(*leaves, causal=causal, padding_mask=pad)
    assert fa.flash_attention_fwd.launches == before[0] + 2


def test_flash_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 144, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, q, q)


# ------------------------------------------ the serve engine's graphs


def _tiny_engine(dev, dtype="float32", **kw):
    from hyperion_tpu_torch.models.llama import Llama, llama_tiny_config
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig

    cfg = llama_tiny_config(n_kv_heads=2, max_len=64, norm_impl="pallas",
                            dtype=dtype)
    model = Llama(cfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(0))
    ecfg = dict(slots=3, max_len=64, block_size=4)
    ecfg.update(kw)
    return Engine(model, EngineConfig(**ecfg), device=dev)


def _serve(eng, prompts, n=8):
    from hyperion_tpu_torch.serve.queue import Request

    reqs = [Request(prompt_ids=p, max_new_tokens=n, id=f"g{i}")
            for i, p in enumerate(prompts)]
    for r in reqs:
        ok, why = eng.submit(r)
        assert ok, why
    while not eng.idle:
        eng.step()
    return reqs


def _graph_prompts(seed=0, lens=(5, 9, 14, 7, 20)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, 6)
    return [np.concatenate([shared, rng.integers(1, 250, n)]).astype(np.int32)
            if i % 2 else rng.integers(1, 250, n).astype(np.int32)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_tick_graph_equals_eager_forward(cuda, dtype):
    """One replay of the captured tick against the model's eager forward
    on the same inputs, over a copy of the pools: logits within 2 ulps of
    the largest logit in the compute dtype (bit-identical when cuBLAS
    picks the same algorithm under capture), the same greedy tokens, and
    the same K/V written."""
    eng = _tiny_engine(cuda, dtype)
    eng.warmup([32])
    _serve(eng, _graph_prompts())
    rng = np.random.default_rng(1)
    S = eng.cfg.slots
    inputs = {"ids": rng.integers(1, 250, (S, 1)).astype(np.int32),
              "start": np.array([3, 17, 30], np.int32),
              "bt": np.stack([rng.permutation(np.arange(1, eng.cfg.num_blocks))
                              [:eng._mb] for _ in range(S)]).astype(np.int32)}
    pools = [{kv: layer[kv].clone() for kv in ("k", "v")}
             for layer in eng._cache]
    assert eng.tier.key("tick", inputs) in eng.tier.graphs
    graph = eng.tier.run("tick", eng._forward, inputs).clone()
    eager, _ = eng.model(torch.as_tensor(inputs["ids"], device=cuda),
                         cache=pools,
                         cache_index=torch.as_tensor(inputs["start"],
                                                     device=cuda),
                         block_tables=torch.as_tensor(inputs["bt"],
                                                      device=cuda))
    eps = torch.finfo(eng.model.cfg.compute_dtype).eps
    tol = 2 * eps * float(eager.abs().max())
    assert float((graph - eager).abs().max()) <= tol
    assert torch.equal(graph.argmax(-1), eager.argmax(-1))
    for a, b in zip(eng._cache, pools):
        for kv in ("k", "v"):
            assert torch.equal(a[kv], b[kv])


def test_engine_launches_count_replays(cuda):
    """Launches = the wrappers' eager launches plus, per replay, what the
    graph captured: forwards x layers for paged attention and forwards x
    (2 layers + 1) for RMSNorm, with spec ticks, chunks and COW copies in
    the mix; compile_stats flat after warmup."""
    eng = _tiny_engine(cuda, spec_k=2, draft="ngram", prefill_chunk=16)
    stats = eng.warmup([32])
    assert stats["spec_tick_executables"] == 1
    assert stats["chunk_executables"] == 1 and stats["copy_executables"] == 1
    paged_attention.launches = fused_rmsnorm.launches = 0
    eng.forwards = 0
    _serve(eng, _graph_prompts(lens=(5, 9, 30, 7, 40)))
    L = eng.model.cfg.n_layers
    assert eng.forwards > 0
    assert paged_attention.launches == eng.forwards * L
    assert fused_rmsnorm.launches == eng.forwards * (2 * L + 1)
    assert eng.compile_stats() == stats and eng.ledger.recompiles == 0
    assert eng.metrics.summary()["cow_copies"] >= 1


def test_engine_streams_equal_eager_generate(cuda):
    """The captured engine's temperature-0 streams equal the eager
    `generate` (no graphs) on the same fp32 weights."""
    from hyperion_tpu_torch.infer.generate import generate

    eng = _tiny_engine(cuda)
    eng.warmup([32])
    reqs = _serve(eng, _graph_prompts())
    for r in reqs:
        ref = generate(eng.model, r.prompt_ids[None], r.max_new_tokens,
                       device=cuda)[0].tolist()
        assert r.tokens == ref, r.id


def test_unwarmed_bucket_captures_one_new_graph(cuda):
    """A prompt past the warmed ladder captures its bucket's graph while
    serving: the ledger counts exactly one recompile, nothing runs
    eagerly in its place, and the stream is still right."""
    from hyperion_tpu_torch.infer.generate import generate

    eng = _tiny_engine(cuda)
    stats = eng.warmup([8])
    (r,) = _serve(eng, _graph_prompts(lens=(20,)), n=4)
    assert eng.ledger.recompiles == 1
    grown = eng.compile_stats()
    assert grown["prefill_executables"] == stats["prefill_executables"] + 1
    assert r.tokens == generate(eng.model, r.prompt_ids[None], 4,
                                device=cuda)[0].tolist()


# ------------------------------------------- train-state checkpoints


def _card_train_state(dev):
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )
    from hyperion_tpu_torch.train.losses import next_token_loss
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer
    from hyperion_tpu_torch.train.step import make_train_step

    cfg = simple_lm_config(vocab_size=4096, d_model=256, n_heads=4,
                           n_layers=2, ff_dim=1024, max_len=64, dropout=0.1,
                           norm_impl="pallas")
    model = TransformerLM(cfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(0))
    state = TrainState(0, model, make_optimizer(model.parameters(), 1e-3))

    def loss_fn(m, b, gen):
        logits = m(b["input_ids"], deterministic=gen is None, generator=gen)
        loss = next_token_loss(logits, b["input_ids"], impl="pallas")
        return loss, {"loss": loss}

    rng = np.random.default_rng(5)
    batch = {"input_ids": torch.as_tensor(
        rng.integers(0, 4096, (16, 64)), dtype=torch.int32, device=dev)}
    return state, make_train_step(loss_fn, dropout=True), batch


def test_async_save_holds_the_pre_step_state(cuda, tmp_path):
    """`save(wait=False)` queues its copies on the compute stream, and
    the next steps' optimizer kernels update the same parameters in
    place right after: the written checkpoint holds the state as of the
    save, byte for byte, and restores it."""
    from hyperion_tpu_torch.checkpoint import io as ckpt_io

    state, train_step, batch = _card_train_state(cuda)
    for _ in range(2):
        train_step(state, batch, 0)
    torch.cuda.synchronize()
    want = {k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}
    want_m = [s["exp_avg"].cpu().clone()
              for s in state.optimizer.adamw.state.values()]
    path = ckpt_io.save(tmp_path / "ck", state, wait=False)
    for _ in range(3):  # launched at once behind the save's copies
        train_step(state, batch, 0)
    assert ckpt_io.wait_pending() == path
    blob = torch.load(path / ckpt_io.SHARD_FILE.format(rank=0, world=1),
                      weights_only=True)
    assert blob["step"] == 2
    for k, v in want.items():
        assert torch.equal(blob["entries"][f"model/{k}"]["data"], v), k
    names = {id(p): n for n, p in state.model.named_parameters()}
    got_m = [blob["entries"][f"adamw/{names[id(p)]}/exp_avg"]["data"]
             for p in state.optimizer.adamw.state]
    assert all(torch.equal(a, b) for a, b in zip(got_m, want_m))
    assert not torch.equal(state.model.state_dict()["lm_head.weight"].cpu(),
                           want["lm_head.weight"])  # training moved on
    fresh, _, _ = _card_train_state(cuda)
    assert ckpt_io.restore(tmp_path / "ck", fresh).step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k
    ckpt_io.release_host_buffers()


def test_prefetched_epoch_equals_sync_on_the_card(cuda):
    """Host rows assembled ahead on the prefetcher's thread, copied to
    the card on the consumer's stream: batch for batch bit-identical to
    `depth=0`."""
    from hyperion_tpu_torch.data.prefetch import Prefetcher
    from hyperion_tpu_torch.data.sharding import ShardedBatches
    from hyperion_tpu_torch.data.text import synthetic_lm_split

    split = synthetic_lm_split(200, seq_len=64, seed=3)
    batches = ShardedBatches(split.arrays(), 8, cuda, seed=7)
    runs = []
    for depth in (0, 3):
        with Prefetcher(batches.host_epoch(2, 1), depth=depth) as feed:
            got = [batches.to_device(b) for b in feed]
        runs.append([{k: v.cpu() for k, v in b.items()} for b in got])
    assert len(runs[0]) == len(runs[1]) == len(batches) - 1
    for a, b in zip(*runs):
        for k in a:
            assert torch.equal(a[k], b[k])


# ------------------------------------------------------------ int8 kernels


def _int8_operands(M, N, K, seed, cuda):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda,
                       dtype=torch.int8)
    sx = torch.rand(M, generator=g, device=cuda) * 0.02 + 1e-4
    sw = torch.rand(N, generator=g, device=cuda) * 0.02 + 1e-4
    bias = torch.randn(N, generator=g, device=cuda)
    return xq, wq, sx, sw, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows, K", [(1, 4096), (3, 100), (17, 11008),
                                     (512, 4096), (5, 1)])
def test_quantize_rows_kernel_bit_identical(cuda, dtype, rows, K):
    """The per-row quantizer against its plain version: q and scale
    bit for bit (a max, two IEEE divisions and rint on both sides), an
    all-zero row among them, and a rerun the same."""
    from hyperion_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=cuda).manual_seed(rows * K)
    x = (torch.randn(rows, K, generator=g, device=cuda) * 3).to(dtype)
    x[rows // 2] = 0
    before = im.quantize_rows.launches
    q, s = im.quantize_rows(x)
    q2, s2 = im.quantize_rows(x)
    torch.cuda.synchronize()
    assert im.quantize_rows.launches == before + 2
    pq, ps = im.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert (q[rows // 2] == 0).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M, N, K", [(1, 4096, 4096), (3, 1000, 4096),
                                     (4, 11008, 4096), (16, 7, 64),
                                     (17, 4096, 11008), (64, 257, 96),
                                     (130, 1000, 4096), (5, 300, 100),
                                     (33, 129, 48)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_kernel_bit_identical(cuda, out_dtype, M, N, K,
                                          with_bias):
    """The product against its plain version (an exact int32 sum, then
    the same fp32 epilogue), ragged M, N and K (K 100 streams by bytes),
    both tiles, with and without a bias; a rerun the same bits."""
    from hyperion_tpu_torch.ops import int8_matmul as im

    xq, wq, sx, sw, bias = _int8_operands(M, N, K, M * N + K, cuda)
    b = bias if with_bias else None
    before = im.int8_matmul.launches
    out = im.int8_matmul(xq, wq, sx, sw, out_dtype, b)
    again = im.int8_matmul(xq, wq, sx, sw, out_dtype, b)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 2
    ref = im.int8_matmul_plain(xq, wq, sx, sw, out_dtype, b)
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, ref)
    assert torch.equal(out, again)
    assert im.int8_matmul_path(M) == ("decode" if M <= 16 else "prefill")


def test_int8_matmul_misaligned_operand_streams_by_bytes(cuda):
    """An operand one byte off the 16-byte grid takes the byte loads and
    gives the same bits."""
    from hyperion_tpu_torch.ops import int8_matmul as im

    xq, wq, sx, sw, _ = _int8_operands(9, 500, 256, 11, cuda)
    flat = torch.empty(xq.numel() + 1, dtype=torch.int8, device=cuda)
    view = flat[1:].view_as(xq)
    view.copy_(xq)
    out = im.int8_matmul(view, wq, sx, sw, torch.bfloat16)
    assert torch.equal(out, im.int8_matmul_plain(xq, wq, sx, sw,
                                                 torch.bfloat16))


def test_int8_kernels_do_not_spill(cuda):
    from hyperion_tpu_torch.ops import int8_matmul as im

    for which, dtypes in (("quantize_rows", (torch.float32, torch.bfloat16,
                                             torch.float16)),
                          ("decode", (torch.float32, torch.bfloat16)),
                          ("prefill", (torch.float32, torch.bfloat16))):
        for dtype in dtypes:
            for vec in (True, False):
                attrs = im.kernel_attrs(which, dtype, vec)
                assert attrs["spill_bytes"] == 0, (which, dtype, vec, attrs)


def test_int8_llama_forward_launches_and_matches_plain(cuda, monkeypatch):
    """A 32-layer int8 Llama at tiny widths, quantized on the card: the
    weights bit-identical to the plain quantizer's on the CPU, one
    forward launches the product 32 * 7 + 1 = 225 times and the
    quantizer as often, and the logits equal bit for bit the same
    model's on the card with the plain versions in place of the
    kernels."""
    from hyperion_tpu_torch.models import llama as tl
    from hyperion_tpu_torch.ops import int8_matmul as im
    from hyperion_tpu_torch.precision import quant as tq
    from hyperion_tpu_torch.precision.quant import quantize_llama

    cfg = tl.llama_tiny_config(n_layers=32, max_len=64)
    float_model = tl.Llama(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    state = float_model.state_dict()
    im.quantize_rows.launches = 0
    qcard, qstate = quantize_llama(state, cfg, device=cuda)
    assert im.quantize_rows.launches == 225
    qcpu, cpu_state = quantize_llama(state, cfg, device="cpu")
    for k, v in cpu_state.items():
        assert torch.equal(qstate[k].cpu(), v), k
    ids = torch.randint(1, 250, (2, 9), generator=torch.Generator()
                        .manual_seed(1))
    im.quantize_rows.launches = im.int8_matmul.launches = 0
    logits, _ = qcard(ids.to(cuda), cache=tl.init_cache(qcard.cfg, 2, 16,
                                                        device=cuda),
                      cache_index=0)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == 225
    assert im.quantize_rows.launches == 225
    monkeypatch.setattr(tq, "quantize_rows", im.quantize_rows_plain)
    monkeypatch.setattr(tq, "_int8_matmul", im.int8_matmul_plain)
    ref, _ = qcard(ids.to(cuda), cache=tl.init_cache(qcard.cfg, 2, 16,
                                                     device=cuda),
                   cache_index=0)
    assert im.int8_matmul.launches == 225
    assert torch.isfinite(logits).all()
    assert torch.equal(logits, ref)
