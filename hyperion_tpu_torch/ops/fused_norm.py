"""RMSNorm and LayerNorm: the hand-written CUDA kernels, their plain
PyTorch versions, and their gradients.

Counterparts in `hyperion_tpu/ops/pallas/fused_norm.py`:

  * `fused_rmsnorm` (`:159`, `_rms_kernel` `:135`): statistics and the
    product in fp32 whatever the input dtype, one cast back — the
    reference's `_rms_reference` order (`:148-151`), not the unfused XLA
    formula of `hyperion_tpu/models/llama.py:167-170`.
  * `fused_layernorm` (`:103`, `_kernel` `:32` with a residual,
    `_kernel_no_res` `:43` without): `LayerNorm(x [+ residual]) * w + b`
    with fp32 mean and two-pass variance, one cast back — `_reference`
    (`:88-95`).

Each public wrapper runs its plain version for a CPU tensor and
launches `csrc/fused_norm.cu` for a CUDA one — or raises on what the
kernel does not take. Neither falls back. Each norm has more than one
kernel there, chosen by the C entry point from the row width and
alignment (a warp a row up to 1024 wide, a block a row past that, and
for RMSNorm scalar loads for any other width or a misaligned view);
`rmsnorm_path`, `rmsnorm_bwd_path` and `layernorm_path` ask which one a
call takes.

Gradients follow the reference's `custom_vjp`s (`_rms_bwd` `:171`,
`_bwd` `:117-126`), which take the VJP of the plain formula. On the
card, RMSNorm's is a kernel of its own (`fused_rmsnorm_bwd`: dx, and dw
when the weight needs one, in one pass over x and g), whose closed form
is `fused_rmsnorm_bwd_plain`; LayerNorm's is still autograd of the plain
version on the saved inputs (`_vjp_of`), not a kernel. Both run through
a `torch.autograd.Function` around the forward launch; a call that
cannot need a gradient (grad mode off, or no input requiring one, as on
the serve path) launches the forward kernel directly and saves nothing.
On the CPU the gradient is autograd of the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyperion_tpu_torch.ops import build

MAX_D = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, weight, y, rows, d, eps, dtype, stream
_RMS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]
# x, residual (may be null), weight, bias, y, rows, d, eps, dtype, stream
_LN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p]
# x, residual, weight, bias, y (each may be null), d, dtype
_LN_PATH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int]
# x, weight, y, d, dtype
_RMS_PATH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int]
# x, weight, g, dx, dw_part, dw (the last three may be null), rows,
# rows_per_block, d, eps, dtype, stream
_RMS_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p]
# x, weight, g, dx (may be null), d, dtype
_RMS_BWD_PATH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
_RMS_PATHS = {0: "scalar", 1: "warp", 2: "block"}
# row blocks a dw reduction spreads over, per SM: each block leaves one
# fp32 row of partial sums, which the second launch adds up
_DW_BLOCKS_PER_SM = 4


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_row_input(name: str, x: torch.Tensor, vecs: dict) -> int:
    """Validate x [..., d] and its [d] fp32 vectors; return d."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"{name} kernel takes 0 < d <= {MAX_D}, got {d}")
    for vname, v in vecs.items():
        if v.dtype != torch.float32 or v.shape != (d,):
            raise ValueError(f"{vname} must be float32 [{d}], got "
                             f"{v.dtype} {tuple(v.shape)}")
    if not (x.is_contiguous() and all(v.is_contiguous()
                                      for v in vecs.values())):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if any(v.device != x.device for v in vecs.values()):
        raise ValueError(f"{name}: all inputs on one device")
    return d


def _vjp_of(plain, saved, needs, g, **kw):
    """Gradients of `plain(*saved, **kw)` against cotangent g, for the
    inputs whose `needs` flag is set (None elsewhere)."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(saved, needs)]
        y = plain(*ins, **kw)
        wrt = [t for t, n in zip(ins, needs) if n and t is not None]
        grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
    return tuple(next(grads) if n and t is not None else None
                 for t, n in zip(ins, needs))


# ---------------------------------------------------------------- RMSNorm


def fused_rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, *,
                        eps: float = 1e-5) -> torch.Tensor:
    """`x * rsqrt(mean(x^2) + eps) * weight` in fp32, cast once to x's
    dtype. x: [..., d]; weight: [d]."""
    h = x.float()
    ms = h.square().mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def _launch_rms(x: torch.Tensor, weight: torch.Tensor,
                eps: float) -> torch.Tensor:
    d = _check_row_input("fused_rmsnorm", x, {"weight": weight})
    fn = build.function("fused_norm", "hyperion_fused_rmsnorm", _RMS_ARGTYPES)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                    x.numel() // d, d, eps, _DTYPES[x.dtype], _stream(x))
    build.check(status, "fused_rmsnorm launch")
    fused_rmsnorm.launches += 1
    return y


def rmsnorm_path(x: torch.Tensor, weight: torch.Tensor) -> str:
    """Which kernel `fused_rmsnorm` launches for these CUDA inputs: "warp"
    (a warp a row: d a whole number of 16-byte chunks, at most 1024, x
    and the weight 16-byte aligned), "block" (a block a row, the same
    rule past 1024 wide) or "scalar" (a block a row with scalar loads:
    any other width or a misaligned view). The C entry point's own rule;
    the output, fresh from the allocator, is aligned. Needs the card."""
    fn = build.function("fused_norm", "hyperion_rmsnorm_path",
                        _RMS_PATH_ARGTYPES)
    return _RMS_PATHS[fn(x.data_ptr(), weight.data_ptr(), None, x.shape[-1],
                         _DTYPES[x.dtype])]


def rmsnorm_bwd_path(x: torch.Tensor, weight: torch.Tensor,
                     g: torch.Tensor) -> str:
    """Which kernel `fused_rmsnorm_bwd` launches for these CUDA inputs:
    "vector" (16-byte chunks: d a whole number of them, x, g and the
    weight 16-byte aligned) or "scalar". Needs the card."""
    fn = build.function("fused_norm", "hyperion_rmsnorm_bwd_path",
                        _RMS_BWD_PATH_ARGTYPES)
    path = fn(x.data_ptr(), weight.data_ptr(), g.data_ptr(), None,
              x.shape[-1], _DTYPES[x.dtype])
    return "vector" if path == 1 else "scalar"


def fused_rmsnorm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                            g: torch.Tensor, *, eps: float = 1e-5
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of `fused_rmsnorm_plain` in closed form, in fp32 with
    r = rsqrt(mean(x^2) + eps):

        dx = r (w g) - x r^3 sum(w g x) / d    (cast once to x's dtype)
        dw = sum over rows of g (x r)          (fp32)

    x, g: [..., d]; weight: [d] float32. Returns (dx, dw)."""
    d = x.shape[-1]
    h = x.float()
    gf = g.float()
    r = torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + eps)
    wg = gf * weight.float()
    s = (wg * h).sum(dim=-1, keepdim=True)
    dx = (r * wg - h * (r.pow(3) * s / d)).to(x.dtype)
    dw = (gf * (h * r)).reshape(-1, d).sum(dim=0)
    return dx, dw


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_rms_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                    eps: float, need_dx: bool, need_dw: bool):
    d = _check_row_input("fused_rmsnorm_bwd", x, {"weight": weight})
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x ({x.dtype} {tuple(x.shape)}), got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("fused_rmsnorm_bwd kernel needs contiguous inputs")
    rows = x.numel() // d
    dx = torch.empty_like(x) if need_dx else None
    dw = part = None
    rows_per_block = 1  # dx alone: a block a row
    if need_dw:
        blocks = max(1, min(rows, _DW_BLOCKS_PER_SM * _sm_count(x.device)))
        rows_per_block = max(1, -(-rows // blocks))
        part = torch.empty(-(-rows // rows_per_block), d, device=x.device)
        # no rows, no launch: the sum over none is zero
        dw = (torch.empty if rows else torch.zeros)(d, device=x.device)
    fn = build.function("fused_norm", "hyperion_rmsnorm_bwd",
                        _RMS_BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), weight.data_ptr(), g.data_ptr(),
                    None if dx is None else dx.data_ptr(),
                    None if part is None else part.data_ptr(),
                    None if dw is None else dw.data_ptr(),
                    rows, rows_per_block, d, eps, _DTYPES[x.dtype],
                    _stream(x))
    build.check(status, "fused_rmsnorm_bwd launch")
    fused_rmsnorm_bwd.launches += 1
    return dx, dw


def fused_rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                      *, eps: float = 1e-5, need_dx: bool = True,
                      need_dw: bool = True):
    """The gradients of `fused_rmsnorm(x, weight)` against cotangent g:
    (dx or None, dw or None), as `fused_rmsnorm_bwd_plain` computes them.
    CPU tensors take that plain version; CUDA tensors one pass of
    `rmsnorm_bwd_kernel` over x and g (and, for dw, a fixed-order
    reduction of its per-block partial sums). g is made contiguous where
    it is not."""
    if x.device.type == "cpu":
        dx, dw = fused_rmsnorm_bwd_plain(x, weight, g, eps=eps)
        return dx if need_dx else None, dw if need_dw else None
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm_bwd: unsupported device {x.device}")
    return _launch_rms_bwd(x, weight, g.contiguous(), eps, need_dx, need_dw)


fused_rmsnorm_bwd.launches = 0  # backward launches since the last reset


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        with torch.profiler.record_function("fused_rmsnorm.forward"):
            ctx.save_for_backward(x, weight)
            ctx.eps = eps
            return _launch_rms(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("fused_rmsnorm.backward"):
            x, weight = ctx.saved_tensors
            need_dx, need_dw = ctx.needs_input_grad[:2]
            dx, dw = fused_rmsnorm_bwd(x, weight, g, eps=ctx.eps,
                                       need_dx=need_dx, need_dw=need_dw)
        return dx, dw, None


def fused_rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """`x * rsqrt(mean(x^2) + eps) * weight`, one pass over x.
    x: [..., d] float32 or bfloat16; weight: [d] float32.
    CPU tensors take the plain version (and its autograd); CUDA tensors
    the kernel, and `fused_rmsnorm_bwd`'s kernel for the gradient."""
    if x.device.type == "cpu":
        return fused_rmsnorm_plain(x, weight, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: unsupported device {x.device}")
    if _needs_grad(x, weight):
        return _RMSNorm.apply(x, weight, eps)
    return _launch_rms(x, weight, eps)


fused_rmsnorm.launches = 0  # kernel launches since the last reset


# -------------------------------------------------------------- LayerNorm


def fused_layernorm_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *,
                          residual: torch.Tensor | None = None,
                          eps: float = 1e-5) -> torch.Tensor:
    """`LayerNorm(x + residual) * weight + bias` in fp32 (mean, then the
    mean of squared deviations), cast once to x's dtype. x, residual:
    [..., d]; weight, bias: [d]."""
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    y = (h - mean) * torch.rsqrt(var + eps) * weight + bias
    return y.to(x.dtype)


def _launch_ln(x, residual, weight, bias, eps) -> torch.Tensor:
    d = _check_row_input("fused_layernorm", x,
                         {"weight": weight, "bias": bias})
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(
                f"residual must match x ({x.dtype} {tuple(x.shape)}), got "
                f"{residual.dtype} {tuple(residual.shape)}")
        if not residual.is_contiguous() or residual.device != x.device:
            raise ValueError("fused_layernorm: residual must be contiguous "
                             "and on x's device")
    fn = build.function("fused_norm", "hyperion_fused_layernorm",
                        _LN_ARGTYPES)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                    x.numel() // d, d, eps, _DTYPES[x.dtype], _stream(x))
    build.check(status, "fused_layernorm launch")
    fused_layernorm.launches += 1
    return y


def layernorm_path(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, *,
                   residual: torch.Tensor | None = None) -> str:
    """Which kernel `fused_layernorm` launches for these CUDA inputs:
    "warp" (a warp a row: d a whole number of 16-byte chunks, at most
    1024, every pointer 16-byte aligned) or "block" (a block a row). The
    C entry point's own rule; the output, fresh from the allocator, is
    aligned. Needs the card."""
    fn = build.function("fused_norm", "hyperion_layernorm_path",
                        _LN_PATH_ARGTYPES)
    path = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
              weight.data_ptr(), bias.data_ptr(), None, x.shape[-1],
              _DTYPES[x.dtype])
    return "warp" if path == 1 else "block"


def _layernorm_for_vjp(x, residual, weight, bias, *, eps):
    return fused_layernorm_plain(x, weight, bias, residual=residual, eps=eps)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps):
        ctx.save_for_backward(x, residual, weight, bias)
        ctx.eps = eps
        return _launch_ln(x, residual, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        return _vjp_of(_layernorm_for_vjp, ctx.saved_tensors,
                       ctx.needs_input_grad[:4], g, eps=ctx.eps) + (None,)


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, *,
                    residual: torch.Tensor | None = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """`LayerNorm(x + residual) * weight + bias` in one pass over x.
    x, residual: [..., d] float32 or bfloat16 (residual optional);
    weight, bias: [d] float32. CPU tensors take the plain version; CUDA
    tensors the kernel, with the plain version's gradient."""
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, weight, bias, residual=residual,
                                     eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    if _needs_grad(x, residual, weight, bias):
        return _LayerNorm.apply(x, residual, weight, bias, eps)
    return _launch_ln(x, residual, weight, bias, eps)


fused_layernorm.launches = 0  # kernel launches since the last reset
