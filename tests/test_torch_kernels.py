"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these hold that version to the reference: `paged_attention_plain`
against `hyperion_tpu/ops/pallas/paged_attention.py` (interpret mode,
as tests/test_pallas_kernels.py runs it), `fused_rmsnorm_plain` and
`fused_layernorm_plain` against `hyperion_tpu/ops/pallas/fused_norm.py`
and `fused_softmax_xent_plain` (and its backward) against
`hyperion_tpu/ops/pallas/fused_ce.py`. The inputs are made with numpy
from a seed and handed to both.

Tolerances: paged attention 2e-5 abs/rel, the reference's own bound
between its online-softmax kernel and the one-shot gather read; the
norms 1e-6 (RMS) and 1e-5 (Layer) in fp32, where the two frameworks sum
in another order, and one bf16 ulp in bf16 (both compute in fp32 and
round once, so at most the last bit may differ); their gradients 1e-5
(RMSNorm's closed-form backward in bf16: dx one ulp, dw in fp32 within
4 sqrt(rows) 2**-24 max|dw|, the rounding of sums over rows taken in
another order); cross-entropy losses 1e-5 relative and dlogits 1e-6 absolute.

The CUDA kernels themselves are held to these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.ops.pallas import fused_ce as jax_ce
from hyperion_tpu.ops.pallas.fused_norm import fused_layernorm as jax_layernorm
from hyperion_tpu.ops.pallas.fused_norm import fused_rmsnorm as jax_rmsnorm
from hyperion_tpu.ops.pallas.paged_attention import (
    paged_attention as jax_paged_attention,
)
from hyperion_tpu_torch.ops import build
from hyperion_tpu_torch.ops import fused_ce as ce_mod
from hyperion_tpu_torch.ops import fused_norm as fn_mod
from hyperion_tpu_torch.ops import paged_attention as pa_mod
from hyperion_tpu_torch.ops.fused_ce import (
    fused_softmax_xent,
    fused_softmax_xent_bwd,
    fused_softmax_xent_bwd_plain,
    fused_softmax_xent_fwd,
    fused_softmax_xent_plain,
)
from hyperion_tpu_torch.ops.fused_norm import (
    fused_layernorm,
    fused_layernorm_plain,
    fused_rmsnorm,
    fused_rmsnorm_bwd,
    fused_rmsnorm_bwd_plain,
    fused_rmsnorm_plain,
)
from hyperion_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)


def _geometry(B, T, H, Hkv, D=16, bs=4, MB=8, seed=0, base=None,
              share_prefix=False):
    """Pools + per-row block chains at random depths; unmapped tail
    entries stay 0 (the null block), as serve/blocks.py hands them to
    the model. numpy arrays, fed to both packages."""
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
    if share_prefix:
        bt[:, 0] = bt[0, 0]  # a radix hit: every row's first block shared
    return q, kp, vp, bt, base


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


GEOMETRIES = {
    "decode_3x1": dict(B=3, T=1, H=4, Hkv=4),
    "verify_3x5": dict(B=3, T=5, H=4, Hkv=4, seed=1),
    "prefill_1x16_mid_base": dict(B=1, T=16, H=4, Hkv=4, seed=2, base=[9]),
    "gqa_8_over_2": dict(B=2, T=3, H=8, Hkv=2, seed=3),
    "shared_prefix": dict(B=3, T=2, H=4, Hkv=4, seed=4, share_prefix=True),
}


class TestPagedAttentionPlain:
    @pytest.mark.parametrize("name", sorted(GEOMETRIES))
    def test_matches_jax_kernel(self, name):
        q, kp, vp, bt, base = _geometry(**GEOMETRIES[name])
        ref = np.asarray(jax_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(base)))
        out = paged_attention_plain(*_torch(q, kp, vp, bt, base)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)

    def test_null_block_poison_is_bit_identical(self):
        """Huge garbage in the null block changes nothing: masked
        positions get exactly zero weight."""
        q, kp, vp, bt, base = _geometry(3, 2, 4, 4, seed=5)
        assert (bt == 0).sum() > 0  # unmapped tails exist
        clean = paged_attention_plain(*_torch(q, kp, vp, bt, base))
        kp[0], vp[0] = 1e4, -1e4
        poisoned = paged_attention_plain(*_torch(q, kp, vp, bt, base))
        assert torch.equal(clean, poisoned)

    def test_cpu_wrapper_is_the_plain_version(self):
        q, kp, vp, bt, base = _torch(*_geometry(2, 3, 8, 2, seed=6))
        before = paged_attention.launches
        assert torch.equal(paged_attention(q, kp, vp, bt, base),
                           paged_attention_plain(q, kp, vp, bt, base))
        assert paged_attention.launches == before  # no kernel launched

    def test_other_devices_raise(self):
        q, kp, vp, bt, base = [t.to("meta") for t in
                               _torch(*_geometry(1, 1, 4, 4))]
        with pytest.raises(ValueError, match="unsupported device"):
            paged_attention(q, kp, vp, bt, base)

    @pytest.mark.parametrize("which", ["q", "k_pool", "v_pool"])
    def test_kernel_refuses_inputs_that_require_grad(self, which):
        """The reference kernel has no VJP: a launch that would hand back
        an output with no gradient path raises instead, before it
        builds. Under no_grad the same inputs pass the check."""
        args = dict(zip(("q", "k_pool", "v_pool", "block_tables", "base"),
                        _torch(*_geometry(2, 1, 4, 4, D=32))))
        args[which].requires_grad_()
        with pytest.raises(RuntimeError, match="no gradient"):
            pa_mod._launch(**args)
        with torch.no_grad(), pytest.raises(TypeError, match="int32"):
            # past the gradient check, into the shape checks
            pa_mod._launch(**{**args, "base": args["base"].long()})

    @pytest.mark.parametrize("bad, match", [
        ("dtype", "float32 or bfloat16"),
        ("head_dim", "multiple of 16"),
        ("table_dtype", "int32"),
        ("pool_dtype", "one dtype"),
        ("strided", "contiguous"),
    ])
    def test_kernel_rejects_what_it_cannot_take(self, bad, match):
        """The launch path validates before it builds or launches."""
        q, kp, vp, bt, base = _torch(*_geometry(
            2, 1, 4, 4, D=40 if bad == "head_dim" else 32))
        if bad == "head_dim":
            for D in (16, 80):  # multiples of 16 pass the planner's check
                assert pa_mod.plan(2, 1, 4, 4, D, 4, 8).n_splits >= 1
        elif bad == "dtype":
            q, kp, vp = q.half(), kp.half(), vp.half()
        elif bad == "table_dtype":
            bt = bt.long()
        elif bad == "pool_dtype":
            kp = kp.bfloat16()
        elif bad == "strided":
            q = q.transpose(2, 3).contiguous().transpose(2, 3)
        with pytest.raises((TypeError, ValueError), match=match):
            pa_mod._launch(q, kp, vp, bt, base)


# (B, T, H, Hkv, D, bs, MB): the serve decode tick and verify window at
# Llama-2-7B heads, 70B's GQA heads, serve's and 70B's prefill windows,
# the CUDA tests' small geometries, a chain of one tile and one of a
# table no split divides
PLAN_SHAPES = {
    "tick_7b": (4, 1, 32, 32, 128, 16, 64),
    "decode_70b": (8, 1, 64, 8, 128, 16, 64),
    "verify_70b": (8, 5, 64, 8, 128, 16, 64),
    "prefill_7b_1024": (1, 1024, 32, 32, 128, 16, 64),
    "prefill_70b_8192_rows": (1, 1024, 64, 8, 128, 16, 256),
    "small_decode_d16": (3, 1, 4, 2, 16, 16, 64),
    "one_tile": (3, 1, 4, 4, 64, 4, 8),
    "ragged_table": (2, 3, 4, 4, 80, 5, 37),
}


class TestPagedAttentionPlan:
    """The kernel's launch plan, a pure function of shapes."""

    @pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
    def test_splits_cover_the_chain_once(self, name):
        B, T, H, Hkv, D, bs, MB = PLAN_SHAPES[name]
        p = pa_mod.plan(B, T, H, Hkv, D, bs, MB)
        L = MB * bs
        assert p.split_len % pa_mod.KV_TILE == 0
        assert p.split_len <= pa_mod.MAX_SPLIT
        covered = np.zeros(L, np.int64)
        for s in range(p.n_splits):
            s0 = s * p.split_len
            assert s0 < L  # no split lies wholly past the table
            covered[s0:min(s0 + p.split_len, L)] += 1
        assert (covered == 1).all()
        # every query row in exactly one row tile
        rows = T * H // Hkv
        assert p.warps in (1, 4)
        assert (p.row_tiles - 1) * 16 * p.warps < rows \
            <= p.row_tiles * 16 * p.warps

    @pytest.mark.parametrize("name", ["prefill_7b_1024",
                                      "prefill_70b_8192_rows", "tick_7b"])
    def test_grid_within_cuda_limits(self, name):
        B, T, H, Hkv, D, bs, MB = PLAN_SHAPES[name]
        p = pa_mod.plan(B, T, H, Hkv, D, bs, MB)
        x, y, z = p.grid(B, Hkv)
        assert 0 < x < 2 ** 31 and 0 < y <= 65535 and 0 < z <= 65535
        assert 32 * p.warps <= 1024
        # the decode tick splits its chains across blocks; a prefill
        # window's row tiles alone fill the card
        if T == 1:
            assert p.n_splits > 1 and p.warps == 1
        else:
            assert p.warps == 4 and x * y * z >= pa_mod.SMS

    def test_plan_reads_no_tensor_data(self):
        """The plan comes from shapes alone: tensors on the meta device,
        which hold no data, give the plan of the same ints, whatever
        `base` and the tables would hold."""
        B, T, H, Hkv, D, bs, MB = PLAN_SHAPES["tick_7b"]
        q = torch.empty(B, T, H, D, device="meta")
        kp = torch.empty(B * MB + 1, bs, Hkv, D, device="meta")
        bt = torch.empty(B, MB, dtype=torch.int32, device="meta")
        assert pa_mod.plan_for(q, kp, bt) == pa_mod.plan(B, T, H, Hkv, D,
                                                         bs, MB)


class TestFusedRMSNormPlain:
    @pytest.mark.parametrize("shape", [(3, 5, 64), (7, 96)])
    def test_fp32_matches_jax_kernel(self, shape):
        rng = np.random.default_rng(sum(shape))
        x = rng.standard_normal(shape).astype(np.float32)
        w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
        ref = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w)))
        out = fused_rmsnorm_plain(*_torch(x, w)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)

    def test_bf16_within_one_ulp_of_jax_kernel(self):
        rng = np.random.default_rng(11)
        x32 = rng.standard_normal((6, 128)).astype(np.float32)
        w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
        xj = jnp.asarray(x32).astype(jnp.bfloat16)
        ref = np.array(jax_rmsnorm(xj, jnp.asarray(w)).astype(jnp.float32))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
        out = fused_rmsnorm_plain(xt, torch.from_numpy(w))
        assert out.dtype == torch.bfloat16
        ulps = (out.view(torch.int16).int()
                - torch.from_numpy(ref).bfloat16().view(torch.int16).int())
        assert int(ulps.abs().max()) <= 1

    def test_cpu_wrapper_is_the_plain_version(self):
        x, w = _torch(np.random.default_rng(0).standard_normal((4, 32))
                      .astype(np.float32), np.ones(32, np.float32))
        before = fused_rmsnorm.launches
        assert torch.equal(fused_rmsnorm(x, w), fused_rmsnorm_plain(x, w))
        assert fused_rmsnorm.launches == before

    @pytest.mark.parametrize("bad, match", [
        ("dtype", "float32 or bfloat16"),
        ("width", "d <= 16384"),
        ("weight", "weight must be float32"),
        ("strided", "contiguous"),
    ])
    def test_kernel_rejects_what_it_cannot_take(self, bad, match):
        d = 16400 if bad == "width" else 64
        x = torch.ones(4, d)
        w = torch.ones(d)
        if bad == "dtype":
            x = x.double()
        elif bad == "weight":
            w = w.bfloat16()
        elif bad == "strided":
            x = torch.ones(d, 4).T
        with pytest.raises((TypeError, ValueError), match=match):
            fn_mod._launch_rms(x, w, 1e-5)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


class TestRMSNormGradient:
    def test_grad_matches_jax_custom_vjp(self):
        rng = np.random.default_rng(21)
        x = rng.standard_normal((5, 48)).astype(np.float32)
        w = (1.0 + 0.1 * rng.standard_normal(48)).astype(np.float32)
        g = rng.standard_normal((5, 48)).astype(np.float32)
        ref = jax.grad(lambda x, w: (jax_rmsnorm(x, w) * g).sum(),
                       argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt, wt = (t.requires_grad_() for t in _torch(x, w))
        (fused_rmsnorm(xt, wt) * torch.from_numpy(g)).sum().backward()
        for out, r in zip((xt.grad, wt.grad), ref):
            np.testing.assert_allclose(out.numpy(), np.asarray(r),
                                       atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("zero_row", [False, True], ids=["", "zero_row"])
    @pytest.mark.parametrize("shape", [(5, 48), (3, 7, 64), (2, 4096)],
                             ids=["5x48", "3x7x64", "2x4096"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bwd_plain_matches_jax_vjp(self, dtype, shape, zero_row):
        """`fused_rmsnorm_bwd_plain` (the card kernel's closed form)
        against `jax.vjp` of the reference's custom_vjp. fp32: dx and dw
        within 1e-5. bf16 (x and g bf16, weight fp32): dx within one ulp
        of the reference's cast; dw, fp32 sums over rows, within
        4 sqrt(rows) 2**-24 max|dw|. A row of zeros has r = eps**-0.5."""
        rng = np.random.default_rng(sum(shape) + zero_row)
        x = rng.standard_normal(shape).astype(np.float32)
        if zero_row:
            x.reshape(-1, shape[-1])[0] = 0.0
        w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
        g = rng.standard_normal(shape).astype(np.float32)
        xj, gj = (jnp.asarray(a).astype(dtype) for a in (x, g))
        _, vjp = jax.vjp(jax_rmsnorm, xj, jnp.asarray(w))
        ref_dx, ref_dw = vjp(gj)
        xt, gt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for a in (xj, gj))
        dx, dw = fused_rmsnorm_bwd_plain(xt, torch.from_numpy(w), gt)
        assert dx.dtype == xt.dtype and dw.dtype == torch.float32
        ref_dw = np.asarray(ref_dw)
        if dtype == "float32":
            np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(dw.numpy(), ref_dw, atol=1e-5,
                                       rtol=1e-5)
            return
        ref_dx = torch.from_numpy(np.array(ref_dx.astype(jnp.float32)))
        assert _ulps(dx, ref_dx.bfloat16()) <= 1
        rows = x.size // shape[-1]
        tol = 4 * np.sqrt(rows) * 2.0 ** -24 * np.abs(ref_dw).max()
        np.testing.assert_allclose(dw.numpy(), ref_dw, atol=tol, rtol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    def test_cpu_path_launches_nothing_and_matches_bwd_plain(self, dtype):
        """On the CPU `fused_rmsnorm`'s gradient is autograd of the plain
        version: no kernel launches, forward or backward, and it agrees
        with the closed form within the tolerances above."""
        rng = np.random.default_rng(22)
        x, g = (torch.from_numpy(rng.standard_normal((6, 128))
                                 .astype(np.float32)).to(dtype)
                for _ in range(2))
        w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(128))
                             .astype(np.float32))
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = (fused_rmsnorm.launches, fused_rmsnorm_bwd.launches)
        fused_rmsnorm(xs, ws).backward(g)
        assert (fused_rmsnorm.launches, fused_rmsnorm_bwd.launches) == before
        dx, dw = fused_rmsnorm_bwd_plain(x, w, g)
        if dtype == torch.bfloat16:
            assert _ulps(xs.grad, dx) <= 1
        else:
            torch.testing.assert_close(xs.grad, dx, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(ws.grad, dw, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("need_dx, need_dw",
                             [(True, True), (True, False), (False, True)])
    def test_cpu_bwd_wrapper_is_the_plain_version(self, need_dx, need_dw):
        rng = np.random.default_rng(23)
        x, g = _torch(*(rng.standard_normal((4, 32)).astype(np.float32)
                        for _ in range(2)))
        w = torch.ones(32)
        before = fused_rmsnorm_bwd.launches
        dx, dw = fused_rmsnorm_bwd(x, w, g, need_dx=need_dx, need_dw=need_dw)
        assert fused_rmsnorm_bwd.launches == before
        ref_dx, ref_dw = fused_rmsnorm_bwd_plain(x, w, g)
        assert (dx is None) == (not need_dx) and (dw is None) == (not need_dw)
        for out, ref in ((dx, ref_dx), (dw, ref_dw)):
            if out is not None:
                assert torch.equal(out, ref)

    @pytest.mark.parametrize("bad, match", [
        ("dtype", "float32 or bfloat16"),
        ("weight", "weight must be float32"),
        ("g_shape", "g must match"),
        ("g_dtype", "g must match"),
        ("strided_g", "contiguous"),
    ])
    def test_bwd_kernel_rejects_what_it_cannot_take(self, bad, match):
        x, g, w = torch.ones(4, 64), torch.ones(4, 64), torch.ones(64)
        if bad == "dtype":
            x, g = x.double(), g.double()
        elif bad == "weight":
            w = w.bfloat16()
        elif bad == "g_shape":
            g = torch.ones(4, 32)
        elif bad == "g_dtype":
            g = g.bfloat16()
        elif bad == "strided_g":
            g = torch.ones(64, 4).T
        with pytest.raises((TypeError, ValueError), match=match):
            fn_mod._launch_rms_bwd(x, w, g, 1e-5, True, True)


class TestFusedLayerNormPlain:
    @pytest.mark.parametrize("residual", [False, True])
    @pytest.mark.parametrize("shape", [(3, 5, 64), (7, 96)])
    def test_fp32_matches_jax_kernel(self, shape, residual):
        rng = np.random.default_rng(sum(shape) + residual)
        x = rng.standard_normal(shape).astype(np.float32) + 0.5
        r = rng.standard_normal(shape).astype(np.float32)
        w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
        b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
        res = jnp.asarray(r) if residual else None
        ref = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), residual=res,
                                       eps=1e-6))
        xt, rt, wt, bt = _torch(x, r, w, b)
        out = fused_layernorm_plain(xt, wt, bt, residual=rt if residual
                                    else None, eps=1e-6).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("residual", [False, True])
    def test_bf16_within_one_ulp_of_jax_kernel(self, residual):
        rng = np.random.default_rng(12 + residual)
        x32, r32 = (rng.standard_normal((6, 256)).astype(np.float32)
                    for _ in range(2))
        w = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
        b = (0.1 * rng.standard_normal(256)).astype(np.float32)
        xj, rj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x32, r32))
        ref = jax_layernorm(xj, jnp.asarray(w), jnp.asarray(b),
                            residual=rj if residual else None, eps=1e-6)
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()
        xt, rt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in (xj, rj))
        out = fused_layernorm_plain(xt, *_torch(w, b),
                                    residual=rt if residual else None,
                                    eps=1e-6)
        assert out.dtype == torch.bfloat16
        assert _ulps(out, ref) <= 1

    @pytest.mark.parametrize("residual", [False, True])
    @pytest.mark.parametrize("d", [256, 768])
    def test_bf16_warp_kernel_widths_within_one_ulp(self, d, residual):
        """The widths the card's warp-a-row LayerNorm kernel takes on the
        main paths (language_ddp's 256, GPT-2's 768): the plain version,
        which that kernel is checked against, within one bf16 ulp of the
        JAX kernel."""
        rng = np.random.default_rng(d + residual)
        x32, r32 = (rng.standard_normal((8, d)).astype(np.float32) + 0.5
                    for _ in range(2))
        w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        b = (0.1 * rng.standard_normal(d)).astype(np.float32)
        xj, rj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x32, r32))
        ref = jax_layernorm(xj, jnp.asarray(w), jnp.asarray(b),
                            residual=rj if residual else None, eps=1e-6)
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()
        xt, rt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in (xj, rj))
        out = fused_layernorm_plain(xt, *_torch(w, b),
                                    residual=rt if residual else None,
                                    eps=1e-6)
        assert out.dtype == torch.bfloat16
        assert _ulps(out, ref) <= 1

    def test_grads_match_jax_custom_vjp(self):
        rng = np.random.default_rng(22)
        x, r, g = (rng.standard_normal((4, 40)).astype(np.float32)
                   for _ in range(3))
        w = (1.0 + 0.1 * rng.standard_normal(40)).astype(np.float32)
        b = (0.1 * rng.standard_normal(40)).astype(np.float32)
        ref = jax.grad(
            lambda x, r, w, b: (jax_layernorm(x, w, b, residual=r, eps=1e-6)
                                * g).sum(), argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (x, r, w, b)))
        ts = [t.requires_grad_() for t in _torch(x, r, w, b)]
        (fused_layernorm(ts[0], ts[2], ts[3], residual=ts[1], eps=1e-6)
         * torch.from_numpy(g)).sum().backward()
        for t, rg in zip(ts, ref):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(rg),
                                       atol=1e-5, rtol=1e-5)

    def test_cpu_wrapper_is_the_plain_version(self):
        x, w, b = _torch(np.random.default_rng(1).standard_normal((4, 32))
                         .astype(np.float32), np.ones(32, np.float32),
                         np.zeros(32, np.float32))
        before = fused_layernorm.launches
        assert torch.equal(fused_layernorm(x, w, b, residual=x),
                           fused_layernorm_plain(x, w, b, residual=x))
        assert fused_layernorm.launches == before

    @pytest.mark.parametrize("bad, match", [
        ("dtype", "float32 or bfloat16"),
        ("width", "d <= 16384"),
        ("bias", "bias must be float32"),
        ("residual", "residual must match"),
        ("strided", "contiguous"),
    ])
    def test_kernel_rejects_what_it_cannot_take(self, bad, match):
        d = 16400 if bad == "width" else 64
        x, w, b = torch.ones(4, d), torch.ones(d), torch.zeros(d)
        res = None
        if bad == "dtype":
            x = x.double()
        elif bad == "bias":
            b = b.bfloat16()
        elif bad == "residual":
            res = torch.ones(4, d).bfloat16()
        elif bad == "strided":
            x = torch.ones(d, 4).T
        with pytest.raises((TypeError, ValueError), match=match):
            fn_mod._launch_ln(x, res, w, b, 1e-6)


class TestFusedSoftmaxXentPlain:
    N, V = 24, 5003  # the vocab ragged against the reference's 2048 tiles

    def _inputs(self, seed=31):
        rng = np.random.default_rng(seed)
        logits = (3 * rng.standard_normal((self.N, self.V))).astype(np.float32)
        targets = rng.integers(0, self.V, self.N).astype(np.int32)
        g = rng.standard_normal(self.N).astype(np.float32) / self.N
        return logits, targets, g

    def test_loss_and_lse_match_jax_forward(self):
        logits, targets, _ = self._inputs()
        ref_loss, (_, _, lse_p, _) = jax_ce._fwd(
            jnp.asarray(logits), jnp.asarray(targets),
            jax_ce.DEFAULT_BLOCK_N, jax_ce.DEFAULT_BLOCK_V)
        loss, lse = fused_softmax_xent_fwd(*_torch(logits, targets))
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p)[:self.N],
                                   rtol=1e-5, atol=0)
        np.testing.assert_array_equal(
            fused_softmax_xent_plain(*_torch(logits, targets)).numpy(),
            loss.numpy())

    def test_gradient_matches_jax_backward(self):
        logits, targets, g = self._inputs(32)
        ref = jax.grad(lambda x: (jax_ce.fused_softmax_xent(
            x, jnp.asarray(targets)) * g).sum())(jnp.asarray(logits))
        lt = torch.from_numpy(logits).requires_grad_()
        (fused_softmax_xent(lt, torch.from_numpy(targets))
         * torch.from_numpy(g)).sum().backward()
        # relative as well: at g ~ 1/N most elements lie far below 1e-6
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref),
                                   atol=1e-12, rtol=1e-5)
        _, lse = fused_softmax_xent_fwd(*_torch(logits, targets))
        direct = fused_softmax_xent_bwd_plain(
            *_torch(logits, targets), lse, torch.from_numpy(g))
        np.testing.assert_allclose(direct.numpy(), np.asarray(ref),
                                   atol=1e-12, rtol=1e-5)

    def test_strided_view_equals_the_copy(self):
        """The [B, T-1, V] view next_token_loss passes equals its
        contiguous copy, forward and backward."""
        rng = np.random.default_rng(33)
        full = torch.from_numpy(rng.standard_normal((3, 5, 300))
                                .astype(np.float32))
        t = torch.from_numpy(rng.integers(0, 300, (3, 4)))
        view = full[:, :-1]
        assert not view.is_contiguous()
        loss_v, lse_v = fused_softmax_xent_fwd(view, t)
        loss_c, lse_c = fused_softmax_xent_fwd(view.contiguous(), t)
        assert torch.equal(loss_v, loss_c) and torch.equal(lse_v, lse_c)
        g = torch.ones(3, 4)
        assert torch.equal(fused_softmax_xent_bwd(view, t, lse_v, g),
                           fused_softmax_xent_bwd(view.contiguous(), t,
                                                  lse_c, g))
        b, r, v, sb, sr = ce_mod._geometry(view, t)
        assert (b, r, v, sb, sr) == (3, 4, 300, 1500, 300)

    def test_cpu_wrappers_are_the_plain_versions(self):
        logits, targets, g = _torch(*self._inputs(34))
        before = (fused_softmax_xent_fwd.launches,
                  fused_softmax_xent_bwd.launches)
        loss, lse = fused_softmax_xent_fwd(logits, targets)
        assert torch.equal(loss, fused_softmax_xent_plain(logits, targets))
        assert torch.equal(fused_softmax_xent_bwd(logits, targets, lse, g),
                           fused_softmax_xent_bwd_plain(logits, targets,
                                                        lse, g))
        assert (fused_softmax_xent_fwd.launches,
                fused_softmax_xent_bwd.launches) == before

    @pytest.mark.parametrize("bad, match", [
        ("dtype", "float32 or\\s+bfloat16"),
        ("target_dtype", "int32 or int64"),
        ("target_high", "must lie in"),
        ("target_low", "must lie in"),
        ("shape", "do not match"),
        ("vocab_stride", "unit stride"),
    ])
    def test_kernel_rejects_what_it_cannot_take(self, bad, match):
        logits, targets = torch.zeros(4, 10), torch.zeros(4, dtype=torch.int64)
        if bad == "dtype":
            logits = logits.half()
        elif bad == "target_dtype":
            targets = targets.float()
        elif bad == "target_high":
            targets[2] = 10
        elif bad == "target_low":
            targets[0] = -1
        elif bad == "shape":
            targets = torch.zeros(5, dtype=torch.int64)
        elif bad == "vocab_stride":
            logits = torch.zeros(10, 4).T
        with pytest.raises((TypeError, ValueError), match=match):
            ce_mod._launch_fwd(logits, targets)
        if bad in ("target_high", "target_low"):
            with pytest.raises(ValueError, match=match):
                ce_mod._launch_bwd(logits, targets, torch.zeros(4),
                                   torch.ones(4))


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        """No nvcc, no kernel: the build raises instead of falling back."""
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build_all()
        assert not (tmp_path / "build").exists()

    def test_function_sets_its_signature_once(self, monkeypatch):
        """A launch after the first pays a lookup: no second load (and
        its lock), no second ctypes set-up."""
        class Lib:
            def __init__(self):
                self.entry = type("Fn", (), {})()

        lib, loads = Lib(), []
        monkeypatch.setattr(build, "_fns", {})
        monkeypatch.setattr(build, "load",
                            lambda stem: loads.append(stem) or lib)
        argtypes = [ctypes.c_void_p, ctypes.c_int]
        first = build.function("k", "entry", argtypes)
        assert first is lib.entry and first.argtypes == argtypes
        assert first.restype is ctypes.c_int
        first.argtypes = None  # a second set-up would restore it
        assert build.function("k", "entry", argtypes) is first
        assert first.argtypes is None and loads == ["k"]

    def test_digest_keys_on_sources(self):
        srcs = sorted(build.CSRC.glob("*.cu"))
        assert {s.stem for s in srcs} == {"flash_attention", "fused_ce",
                                          "fused_norm", "int8_matmul",
                                          "paged_attention"}
        assert build._digest(srcs) == build._digest(srcs)
        assert build._digest(srcs[:1]) != build._digest(srcs)
