"""Flash attention: the hand-written CUDA kernels (forward, dq, dk/dv),
their plain PyTorch versions, and the autograd glue.

Counterpart: `hyperion_tpu/ops/pallas/flash_attention.py` —
`flash_attention` (`:616`), whose forward is `_flash_forward` (`:277`,
`_fwd_kernel` `:207`) and whose `custom_vjp` backward is
`_flash_backward` (`:467`: `_dq_kernel` `:351`, `_dkv_kernel` `:405`).

The contract is the JAX kernels', not the "xla" attention's (which
pre-scales q in the input dtype, `ops/attention.py`): s = q·kᵀ
accumulated in fp32, times 1/√D in fp32; masked entries (causal
`kv <= q` from position 0, and the `[B, Tkv]` key padding mask) set to
`NEG_INF`; softmax statistics in fp32; p cast to the input dtype before
p·v, accumulated in fp32; o = acc / max(l, 1e-30) in the input dtype;
lse = m + log(max(l, 1e-30)), a compact `[B, H, Tq]` fp32 array. The
backward recomputes p = exp(s − lse) from the saved lse and takes
delta = Σ dO·O in fp32, which the reference computes outside its kernels
(`_flash_backward` `:479-484`) and the dq kernel computes here, for the
dk/dv launch. Rows whose keys are all masked give garbage outputs and
clean gradients, as the reference documents (`:43-46`).

Wrappers, each with its launch count: `flash_attention_fwd` (o, and lse
when asked for), `flash_attention_dq` and `flash_attention_dkv`. On a
CPU tensor each runs its plain version, a full-matrix formula of the
same math with no tiles; on a CUDA tensor it launches
`csrc/flash_attention.cu` or raises. The kernels are built per dtype
(`HEAD_DIMS`): bf16 at D 64, 80, 96, 128 and 256, fp32 at D 32, 64, 128
and 256; any other D up to 256 runs on the next of its dtype's
(`kernel_head_dim`) with the scale of its true D, as if zero columns
were appended: zero columns add exact zeros to q·kᵀ, and the
padded columns of v only fill columns that are never written. bf16 at a
D that is a multiple of 8 reaches the kernels in place: their TMA maps
read the tensors at their own width and fill the columns past it with
zeros, and o and the gradients are allocated and written at width D.
fp32, and bf16 at any other D, are copied zero-padded to the kernel's
width and o and the gradients sliced back (`host_padded`). bf16 runs
that file's Hopper kernels (wgmma, TMA, warp-specialised) for the
forward and both backward kernels; fp32 runs its split-TF32 kernels (each
product as three TF32 tensor-core passes over operands split as
x = hi + lo, `split_tf32` being the split's plain model), within the
reference's fp32 bounds of the plain versions. Past 256 (the reference's
kernels tile the whole D and take any) every D runs on the wide kernels
of `csrc/flash_attention_wide.cu` at its own width, in both dtypes:
bf16 on mma.sync, the products over D in 64-column steps and each block
owning a chunk of the output's columns; fp32 on split TF32, a
thread-block cluster a row tile whose blocks each own a slice of D and
sum their partial logits across the cluster, so that s is computed once
a tile (`wide_plan`: one pass up to 2048, then a pass per 2048 columns).
`kernel_attrs` reads what the compiler gave each kernel (registers,
spills, shared memory, the function's name; past 256 the cluster).
`flash_attention` is the differentiable entry point: a
`torch.autograd.Function` that saves q, k, v, the mask, o and lse, as
the reference's `_fwd` does, and runs the two backward kernels; a call
that needs no gradient skips the lse write, as the reference's
`need_lse=False` does.

`block_q` / `block_kv` are the TPU kernel's tiling knobs: accepted, and
left to the kernel, whose tile is fixed. `_pick_block`'s limits and the
Mosaic layout workarounds (`LANES`, `SUBLANES`, `_mask_arg`) have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import math
import warnings

import torch

from hyperion_tpu_torch.ops import build
from hyperion_tpu_torch.ops.attention import NEG_INF

# the kernels' instantiations per dtype; any D up to 256 runs on the next,
# any D past it on the wide kernels at D itself
HEAD_DIMS = {torch.bfloat16: (64, 80, 96, 128, 256),
             torch.float32: (32, 64, 128, 256)}
WIDE = 256  # past this head_dim: csrc/flash_attention_wide.cu
# fp32 past 256: clusters of at most 16 blocks, a slice of at most 128
# columns each (`wide_plan`)
WIDE_CLUSTER_MAX, WIDE_SLICE_MAX = 16, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# q, k, v, pad, o, lse; B, Tq, Tkv, H, D (the kernel's), W (the tensors'),
# causal; scale; dtype; stream
_FWD_ARGTYPES = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _P]
# q, k, v, pad, dout, o, lse, delta, dq; B, Tq, Tkv, H, D, W, causal; ...
_DQ_ARGTYPES = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _P]
# q, k, v, pad, dout, lse, delta, dk, dv; B, Tq, Tkv, H, D, W, causal; ...
_DKV_ARGTYPES = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _P]
# which (0 forward, 1 dq, 2 dk/dv), D, W, dtype, int out[5] (the wide
# kernels' fifth: blocks a cluster); the function's name and its
# buffer's bytes
_ATTRS_ARGTYPES = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_char_p, _I]


def _scale(D: int) -> float:
    """1/sqrt(D): a Python float, rounded to fp32 where it meets an fp32
    tensor, as the reference's weak-typed `sm_scale` is."""
    return 1.0 / math.sqrt(D)


def kernel_head_dim(D: int, dtype: torch.dtype) -> int:
    """The kernel head_dim that runs a head_dim D in `dtype`: the least
    of its HEAD_DIMS at or above it, or D itself past 256 (the wide
    kernels). Raises ValueError for D < 1."""
    if D > WIDE:
        return D
    for Dk in HEAD_DIMS[dtype]:
        if 0 < D <= Dk:
            return Dk
    raise ValueError(f"flash_attention takes head_dim >= 1, got {D}")


def _entry(dims, which: str) -> tuple[str, str]:
    """(source stem, C entry point) of the launch `which` ("fwd", "dq",
    "dkv", "attrs") at these dims: the wide kernels past D 256."""
    if dims[4] > WIDE:
        return "flash_attention_wide", f"hyperion_flash_wide_{which}"
    return "flash_attention", f"hyperion_flash_{which}"


def wide_plan(D: int) -> dict:
    """The fp32 wide kernels' launch at head_dim D past 256, as
    `tf32::plan` in `csrc/flash_attention_wide.cu` computes it. Up to
    2048: a cluster of ceil(D / 128) blocks, block r owning the columns
    `slices[r]` of D (`slice` = D / cluster rounded up to 8 wide, the last
    the rest), in one pass. Past 2048: a cluster of 16, slices of 128,
    block r owning `slices[r::16]`, and ceil(len(slices) / 16) `passes`,
    pass p's block r writing `slices[r + 16 p]`. Raises ValueError up to
    256."""
    if D <= WIDE:
        raise ValueError(f"the fp32 wide flash kernels take head_dim > "
                         f"{WIDE}, got {D}")
    C = -(-D // WIDE_SLICE_MAX)
    if C > WIDE_CLUSTER_MAX:
        sw, passes, C = WIDE_SLICE_MAX, -(-C // WIDE_CLUSTER_MAX), \
            WIDE_CLUSTER_MAX
    else:
        sw, passes = (-(-D // C) + 7) // 8 * 8, 1
    return {"cluster": C, "slice": sw, "passes": passes,
            "slices": [(c0, min(D, c0 + sw)) for c0 in range(0, D, sw)]}


def host_padded(D: int, dtype: torch.dtype) -> bool:
    """Whether a head_dim D in `dtype` reaches the kernels as copies
    zero-padded to `kernel_head_dim`. Not where D is an instantiation or
    past 256 (the wide kernels read the tensors at D), nor for bf16 at a
    D that is a multiple of 8: the Hopper kernels' TMA maps
    take a row stride of D·2 bytes if it is a multiple of 16, and read the
    columns past D as zeros. fp32 (the split-TF32 kernels read rows raw at
    the kernel's width) and bf16 at any other D are copied."""
    if kernel_head_dim(D, dtype) == D:
        return False
    return dtype != torch.bfloat16 or D % 8 != 0


def pad_head_dim(t: torch.Tensor, Dk: int) -> torch.Tensor:
    """t [..., D] with zero columns appended up to Dk (t itself if D is
    Dk)."""
    D = t.shape[-1]
    return t if D == Dk else torch.nn.functional.pad(t, (0, Dk - D))


# ------------------------------------------------------------ plain math


def _logits(q, k, causal, padding_mask, scale=None):
    """Scaled, masked fp32 logits [B, H, Tq, Tkv]; `scale` 1/sqrt(D)
    unless given."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (_scale(q.shape[-1]) if scale is None else scale)
    Tq, Tkv = q.shape[1], k.shape[1]
    keep = None
    if causal:
        keep = (torch.arange(Tkv, device=q.device)[None, :]
                <= torch.arange(Tq, device=q.device)[:, None])[None, None]
    if padding_mask is not None:
        pad = padding_mask.to(q.device, torch.bool)[:, None, None, :]
        keep = pad if keep is None else keep & pad
    return s if keep is None else s.masked_fill(~keep, NEG_INF)


def flash_attention_fwd_plain(q, k, v, *, causal=False, padding_mask=None,
                              scale=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] fp32): the forward
    kernel's arithmetic over the whole logits matrix at once. `scale`:
    1/sqrt(D) unless given (a zero-padded D keeps its true one)."""
    s = _logits(q, k, causal, padding_mask, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, g, *, causal=False,
                              padding_mask=None, scale=None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype from the saved o and lse and
    the cotangent g: the two backward kernels' arithmetic over whole
    matrices. `scale` as in the forward."""
    dt = q.dtype
    scale = _scale(q.shape[-1]) if scale is None else scale
    p = torch.exp(_logits(q, k, causal, padding_mask, scale) - lse[..., None])
    gf = g.float()
    delta = (gf * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


# --------------------------------------------------------------- kernels


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernels' vector
    loads); copies only a view that is neither."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, padding_mask):
    """Validate what the kernels take; return (B, Tq, Tkv, H, Dk, D) — Dk
    the kernel head_dim that runs D — and the mask as contiguous int32 (or
    None)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention kernel takes q [B, Tq, H, D] and "
                         f"k, v [B, Tkv, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes q, k and v in one dtype")
    B, Tq, H, D = q.shape
    Tkv = k.shape[1]
    Dk = kernel_head_dim(D, q.dtype)
    if max(B, H, B * Tq * H * Dk, B * Tkv * H * Dk) >= 2 ** 31:
        raise ValueError(f"flash_attention kernel: shape {tuple(q.shape)} "
                         "out of range")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: all inputs on one device")
    pad = None
    if padding_mask is not None:
        if tuple(padding_mask.shape) != (B, Tkv):
            raise ValueError(f"padding_mask must be [{B}, {Tkv}], got "
                             f"{tuple(padding_mask.shape)}")
        pad = padding_mask.to(q.device, torch.int32).contiguous()
    return (B, Tq, Tkv, H, Dk, D), pad


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _what(label: str, dims, t: torch.Tensor) -> str:
    """A launch's name for its error: the head dims and the dtype."""
    return (f"flash_attention {label} launch (head_dim {dims[5]}, kernel "
            f"{dims[4]}, width {t.shape[-1]}, {t.dtype})")


def _run_fwd(dims, pad, q, k, v, causal, need_lse):
    """The forward launch on inputs of width W (D, or the kernel's Dk
    where `host_padded`), scaled for D; o comes back at width W."""
    B, Tq, Tkv, H, Dk, D = dims
    fn = build.function(*_entry(dims, "fwd"), _FWD_ARGTYPES)
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad),
                    o.data_ptr(), _ptr(lse), B, Tq, Tkv, H, Dk, q.shape[-1],
                    int(causal), _scale(D), _DTYPES[q.dtype], _stream(q))
    build.check(status, _what("forward", dims, q))
    flash_attention_fwd.launches += 1
    return o, lse


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _width(dims, dtype) -> int:
    """The width the launch takes the tensors at: D itself, or the
    kernel's Dk where `host_padded`."""
    Dk, D = dims[4:]
    return Dk if host_padded(D, dtype) else D


def _launch_fwd(q, k, v, padding_mask, causal, need_lse):
    dims, pad = _check(q, k, v, padding_mask)
    W = _width(dims, q.dtype)
    q, k, v = (_aligned(pad_head_dim(t, W)) for t in (q, k, v))
    o, lse = _run_fwd(dims, pad, q, k, v, causal, need_lse)
    return _unpad(o, dims[5]), lse


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with x ≈ hi + lo: the fp32 kernels' operand split, in
    plain PyTorch. hi is x rounded to TF32 (10 mantissa bits; nearest,
    ties away from zero) by integer ops on the fp32 bits, as
    `csrc/flash_attention.cu`'s `round_tf32` does; lo is the remainder
    x − hi rounded the same way. Three TF32 products lo·hi + hi·lo +
    hi·hi then carry a product to ~2⁻²² of its terms."""

    def rnd(t: torch.Tensor) -> torch.Tensor:
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rnd(x)
    return hi, rnd(x.float() - hi)


def _bwd_inputs(q, k, v, o, lse, g, padding_mask):
    """Checked, aligned backward inputs (q, k, v, g, o, lse), the first
    five zero-padded to the kernel head_dim where `host_padded`."""
    dims, pad = _check(q, k, v, padding_mask)
    B, Tq, _, H, _, _ = dims
    for name, t in (("o", o), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({q.dtype} "
                             f"{tuple(q.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Tq):
        raise ValueError(f"lse must be float32 [{B}, {H}, {Tq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    W = _width(dims, q.dtype)
    return dims, pad, (*(_aligned(pad_head_dim(t, W))
                         for t in (q, k, v, g, o)), lse.contiguous())


def _launch_dq(dims, pad, q, k, v, g, o, lse, causal):
    """(dq, delta): the kernel computes delta = Σ dO·O [B, H, Tq] from g
    and o and returns it for the dk/dv launch."""
    B, Tq, Tkv, H, Dk, D = dims
    fn = build.function(*_entry(dims, "dq"), _DQ_ARGTYPES)
    dq = torch.empty_like(q)
    delta = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad),
                    g.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Tq,
                    Tkv, H, Dk, q.shape[-1], int(causal), _scale(D),
                    _DTYPES[q.dtype], _stream(q))
    build.check(status, _what("dq", dims, q))
    flash_attention_dq.launches += 1
    return _unpad(dq, D), delta


def _launch_dkv(dims, pad, q, k, v, g, o, lse, delta, causal):
    del o  # the inputs are _bwd_inputs', shared with dq
    B, Tq, Tkv, H, Dk, D = dims
    fn = build.function(*_entry(dims, "dkv"), _DKV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad),
                    g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, Tq, Tkv, H, Dk,
                    q.shape[-1], int(causal), _scale(D), _DTYPES[q.dtype],
                    _stream(q))
    build.check(status, _what("dk/dv", dims, q))
    flash_attention_dkv.launches += 1
    return _unpad(dk, D), _unpad(dv, D)


def function_name(signature: str) -> str:
    """A kernel's name from the signature the runtime gives it, demangled:
    `void (anonymous namespace)::flash_fwd_kernel_tf32<128>(float const*,
    ...)` is `flash_fwd_kernel_tf32<128>`."""
    head = signature.replace("(anonymous namespace)::", "").split("(")[0]
    return head.removeprefix("void ")


def kernel_attrs(which: str, D: int, dtype: torch.dtype) -> dict:
    """What the compiler gave the kernel that `which` ("fwd", "dq", "dkv")
    launches at this head_dim (that is, at its kernel head_dim and the
    width its tensors reach it at) and dtype: registers and local-memory
    (spill) bytes a thread, shared memory and threads a block, and the
    name of the function the launch runs, as the runtime names the one
    the C dispatch picked (`function_name`; fp32 past 2048 runs the
    `_passes` kernels); past 256 also the blocks of its cluster (1 in
    bf16; `wide_plan`'s in fp32). Needs the card."""
    Dk = kernel_head_dim(D, dtype)
    fn = build.function(*_entry((0, 0, 0, 0, Dk, D), "attrs"),
                        _ATTRS_ARGTYPES)
    out = (ctypes.c_int * 5)()
    name = ctypes.create_string_buffer(512)
    build.check(fn({"fwd": 0, "dq": 1, "dkv": 2}[which], Dk,
                   Dk if host_padded(D, dtype) else D, _DTYPES[dtype], out,
                   name, len(name)),
                "flash_attention kernel attributes")
    rec = {"registers": out[0], "spill_bytes": out[1],
           "smem_bytes": out[2], "threads": out[3],
           "function": function_name(name.value.decode())}
    if D > WIDE:
        rec["cluster"] = out[4]
    return rec


def flash_attention_fwd(q, k, v, *, causal=False, padding_mask=None,
                        need_lse=True):
    """The forward kernel: (o, lse), lse None unless `need_lse`. No
    autograd."""
    if _on_card("flash_attention_fwd", q):
        return _launch_fwd(q, k, v, padding_mask, causal, need_lse)
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                       padding_mask=padding_mask)
    return o, (lse if need_lse else None)


flash_attention_fwd.launches = 0  # kernel launches since the last reset


def flash_attention_dq(q, k, v, o, lse, g, *, causal=False,
                       padding_mask=None):
    """The dq kernel: dq in q's shape and dtype."""
    if _on_card("flash_attention_dq", q):
        dims, pad, ins = _bwd_inputs(q, k, v, o, lse, g, padding_mask)
        return _launch_dq(dims, pad, *ins, causal)[0]
    return flash_attention_bwd_plain(q, k, v, o, lse, g, causal=causal,
                                     padding_mask=padding_mask)[0]


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, o, lse, g, *, causal=False,
                        padding_mask=None):
    """The dk/dv kernel: (dk, dv) in k's shape and dtype, from a
    delta = Σ dO·O made here (`flash_attention_bwd` takes dq's)."""
    if _on_card("flash_attention_dkv", q):
        dims, pad, ins = _bwd_inputs(q, k, v, o, lse, g, padding_mask)
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return _launch_dkv(dims, pad, *ins, delta, causal)
    return flash_attention_bwd_plain(q, k, v, o, lse, g, causal=causal,
                                     padding_mask=padding_mask)[1:]


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, g, *, causal=False,
                        padding_mask=None):
    """(dq, dk, dv): both backward kernels on one delta on the card (the
    dq kernel computes it and hands it to dk/dv), the plain backward on
    the CPU."""
    if not _on_card("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, g, causal=causal,
                                         padding_mask=padding_mask)
    dims, pad, ins = _bwd_inputs(q, k, v, o, lse, g, padding_mask)
    dq, delta = _launch_dq(dims, pad, *ins, causal)
    dk, dv = _launch_dkv(dims, pad, *ins, delta, causal)
    return dq, dk, dv


# -------------------------------------------------------------- autograd


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, padding_mask, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     padding_mask=padding_mask)
        ctx.save_for_backward(q, k, v, padding_mask, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, padding_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g.contiguous(),
                                         causal=ctx.causal,
                                         padding_mask=padding_mask)
        return dq, dk, dv, None, None


_NARROWING_WARNED: set[tuple[str, str, str]] = set()


def _warn_if_narrowing(q_dtype, k_dtype, v_dtype) -> None:
    """Warn once per dtype combination when bringing k or v to q's dtype
    loses precision (`_warn_if_narrowing` of the reference, `:590`)."""
    q_bits = torch.finfo(q_dtype).bits
    for name, d in (("k", k_dtype), ("v", v_dtype)):
        bits = torch.finfo(d).bits
        key = (str(q_dtype), name, str(d))
        if bits > q_bits and key not in _NARROWING_WARNED:
            _NARROWING_WARNED.add(key)
            warnings.warn(
                f"flash_attention: {name} is {d} but q is {q_dtype}; "
                f"reconciling to q's dtype NARROWS {name} from {bits} to "
                f"{q_bits} bits per element (e.g. a bf16 query against an "
                "fp32 KV cache). Cast q up, or store K/V in the compute "
                "dtype, if that precision matters. (warned once per dtype "
                "combination)", stacklevel=3)


def flash_attention(q, k, v, *, causal: bool = False, padding_mask=None,
                    block_q: int | None = None,
                    block_kv: int | None = None) -> torch.Tensor:
    """Attention over [B, T, H, D] tensors; padding_mask [B, Tkv], 1 =
    real token. k and v are brought to q's dtype (with a warning when
    that narrows them). `block_q`/`block_kv` are accepted for the
    reference's signature; the kernel's tile is its own."""
    del block_q, block_kv
    if not (q.dtype == k.dtype == v.dtype):
        _warn_if_narrowing(q.dtype, k.dtype, v.dtype)
        k, v = k.to(q.dtype), v.to(q.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, padding_mask, causal)
    return flash_attention_fwd(q, k, v, causal=causal,
                               padding_mask=padding_mask, need_lse=False)[0]
