"""Fused softmax cross-entropy: the hand-written CUDA kernels (forward
and backward), their plain PyTorch versions, and the autograd glue.

Counterpart: `hyperion_tpu/ops/pallas/fused_ce.py` — `fused_softmax_xent`
(`:123`, forward `_fwd_kernel` `:61` via `_run_forward` `:132`),
`fused_softmax_xent_fwd_only` (`:173`) and the backward `_bwd` (`:180`,
`_bwd_kernel` `:94`). Per row: `loss = lse - logits[target]` with
`lse = logsumexp(logits)` in fp32, and `dlogits = (softmax - onehot) *
g`, recomputed from the saved lse.

Shapes: logits [..., V] (fp32 or bf16), targets [...] integer in
[0, V); loss [...] fp32. The JAX functions take [N, V]; the port also
takes a row-strided [B, R, V] view, which the kernels read in place.
`fused_softmax_xent_shifted` is the loss path's entry: it takes the
model's whole [B, T, V] logits and [B, T-1] targets, scores rows
t < T-1 by strides, and its backward kernel writes the gradient of the
whole [B, T, V] tensor, the last position zero, so autograd runs no
slice backward (a zero-fill and a copy of the step's largest tensor).

`fused_softmax_xent_fwd` and `fused_softmax_xent_bwd` are the two kernel
wrappers, each with its own launch count. On a CPU tensor they run the
plain version; on a CUDA tensor they launch or raise. Targets out of
range raise in the wrapper: the check is one device-to-host read a
call, and one a train step through `fused_softmax_xent`, whose backward
reuses the targets its forward checked.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hyperion_tpu_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2 ** 31 - 1  # the kernels' grid: one block per row
# logits, targets, loss, lse; B, R, V; sb, sr; dtype; stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
# logits, targets, lse, g, dlogits; B, R, V; sb, sr; Rd; dsb, dsr; dtype;
# stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [
    ctypes.c_int, ctypes.c_void_p]


# ------------------------------------------------------------ plain math


def fused_softmax_xent_plain(logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """Per-row `logsumexp(logits) - logits[target]` in fp32 — the
    reference's `optax.softmax_cross_entropy_with_integer_labels`. Its
    autograd is the plain backward."""
    return _plain_fwd(logits, targets)[0]


def _plain_fwd(logits, targets):
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = x.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked, lse


def fused_softmax_xent_bwd_plain(logits: torch.Tensor, targets: torch.Tensor,
                                 lse: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """`(exp(logits - lse) - onehot(targets)) * g` in fp32, cast once to
    the logits' dtype — `_bwd_kernel`'s arithmetic."""
    p = torch.exp(logits.float() - lse.unsqueeze(-1))
    onehot = torch.zeros_like(p).scatter_(
        -1, targets.long().unsqueeze(-1), 1.0)
    return ((p - onehot) * g.float().unsqueeze(-1)).to(logits.dtype)


# --------------------------------------------------------------- kernels


def _geometry(logits: torch.Tensor, targets: torch.Tensor):
    """(B, R, V, sb, sr) of logits as B x R rows with element strides
    (sb, sr) and unit stride along V, after validating what the kernels
    take."""
    if logits.dtype not in _DTYPES:
        raise TypeError(f"fused_softmax_xent kernel takes float32 or "
                        f"bfloat16 logits, got {logits.dtype}")
    if logits.dim() not in (2, 3):
        raise ValueError(f"fused_softmax_xent kernel takes [N, V] or "
                         f"[B, R, V] logits, got {tuple(logits.shape)}")
    if tuple(targets.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"targets {tuple(targets.shape)} do not match "
                         f"logits {tuple(logits.shape)}")
    if targets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"targets must be int32 or int64, got "
                        f"{targets.dtype}")
    if targets.device != logits.device:
        raise ValueError("fused_softmax_xent: all inputs on one device")
    if logits.stride(-1) != 1:
        raise ValueError("fused_softmax_xent kernel needs unit stride "
                         "along the vocab")
    lg = logits if logits.dim() == 3 else logits.unsqueeze(0)
    B, R, V = lg.shape
    if not 0 < V < 2 ** 31 or B * R > _MAX_ROWS:
        raise ValueError(f"fused_softmax_xent kernel: shape "
                         f"{tuple(logits.shape)} out of range")
    return B, R, V, lg.stride(0), lg.stride(1)


def _checked_targets(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Validate the inputs and return the targets as the kernels read
    them: contiguous int32, each in [0, V) — checked here, where a bad
    one can still raise, at the cost of one device-to-host read."""
    V = _geometry(logits, targets)[2]
    if targets.numel():
        lo, hi = torch.stack(torch.aminmax(targets)).tolist()
        if lo < 0 or hi >= V:
            raise ValueError(f"targets must lie in [0, {V}), got "
                             f"[{lo}, {hi}]")
    return targets.to(torch.int32).contiguous()


def _kernel_geometry(logits, t32):
    if t32.dtype != torch.int32 or not t32.is_contiguous():
        raise ValueError("the kernels take checked targets "
                         "(_checked_targets)")
    return _geometry(logits, t32)


def _run_fwd(logits, t32):
    """Launch the forward kernel on checked targets."""
    B, R, V, sb, sr = _kernel_geometry(logits, t32)
    fn = build.function("fused_ce", "hyperion_fused_ce_fwd", _FWD_ARGTYPES)
    loss = torch.empty(logits.shape[:-1], dtype=torch.float32,
                       device=logits.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        status = fn(logits.data_ptr(), t32.data_ptr(), loss.data_ptr(),
                    lse.data_ptr(), B, R, V, sb, sr, _DTYPES[logits.dtype],
                    stream)
    build.check(status, "fused_softmax_xent forward launch")
    fused_softmax_xent_fwd.launches += 1
    return loss, lse


def _launch_fwd(logits, targets):
    return _run_fwd(logits, _checked_targets(logits, targets))


def _like_on_grid(src: torch.Tensor, shape) -> torch.Tensor:
    """An uninitialised contiguous tensor of `shape` in src's dtype whose
    first element sits where src's does against the 16-byte grid, so a
    row of each at the same element offset takes the kernel's 16-byte
    body, whatever src's storage offset."""
    skew = src.data_ptr() % 16 // src.element_size()
    buf = torch.empty(math.prod(shape) + skew, dtype=src.dtype,
                      device=src.device)
    return buf[skew:].view(shape)


def _run_bwd_into(logits, t32, lse, g, dst):
    """Launch the backward kernel on checked targets into `dst`, [B, Rd,
    V] with Rd >= R (or [N, V] for [N, V] logits): the first R rows of
    each batch get dlogits, the rest zeros."""
    B, R, V, sb, sr = _kernel_geometry(logits, t32)
    rows_shape = tuple(logits.shape[:-1])
    for name, v in (("lse", lse), ("g", g)):
        if v.dtype != torch.float32 or tuple(v.shape) != rows_shape:
            raise ValueError(f"{name} must be float32 {list(rows_shape)}, "
                             f"got {v.dtype} {tuple(v.shape)}")
        if v.device != logits.device:
            raise ValueError("fused_softmax_xent: all inputs on one device")
    d3 = dst if dst.dim() == 3 else dst.unsqueeze(0)
    if (dst.dim() != logits.dim() or d3.shape[0] != B or d3.shape[1] < R
            or d3.shape[2] != V or dst.dtype != logits.dtype
            or dst.device != logits.device or dst.stride(-1) != 1
            or B * d3.shape[1] > _MAX_ROWS):
        raise ValueError(f"dlogits {dst.dtype} {tuple(dst.shape)} cannot "
                         f"take the gradient of {logits.dtype} "
                         f"{tuple(logits.shape)}")
    lse, g = lse.contiguous(), g.contiguous()
    fn = build.function("fused_ce", "hyperion_fused_ce_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        status = fn(logits.data_ptr(), t32.data_ptr(), lse.data_ptr(),
                    g.data_ptr(), dst.data_ptr(), B, R, V, sb, sr,
                    d3.shape[1], d3.stride(0), d3.stride(1),
                    _DTYPES[logits.dtype], stream)
    build.check(status, "fused_softmax_xent backward launch")
    fused_softmax_xent_bwd.launches += 1
    return dst


def _run_bwd(logits, t32, lse, g):
    """dlogits in the logits' shape, contiguous."""
    return _run_bwd_into(logits, t32, lse, g,
                         _like_on_grid(logits, logits.shape))


def _run_bwd_shifted(logits, t32, lse, g):
    """The gradient of the whole [B, T, V] logits of a loss over their
    rows t < T-1 (t32, lse, g: [B, T-1]); row T-1 zero."""
    return _run_bwd_into(logits[:, :-1], t32, lse, g,
                         _like_on_grid(logits, logits.shape))


def _launch_bwd(logits, targets, lse, g):
    return _run_bwd(logits, _checked_targets(logits, targets), lse, g)


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def fused_softmax_xent_fwd(logits: torch.Tensor, targets: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (loss, lse), both fp32 [...]. No autograd."""
    if _on_card("fused_softmax_xent_fwd", logits):
        return _launch_fwd(logits, targets)
    return _plain_fwd(logits.detach(), targets)


fused_softmax_xent_fwd.launches = 0  # kernel launches since the last reset


def fused_softmax_xent_bwd(logits: torch.Tensor, targets: torch.Tensor,
                           lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel: dlogits in the logits' shape and dtype."""
    if _on_card("fused_softmax_xent_bwd", logits):
        return _launch_bwd(logits, targets, lse, g)
    return fused_softmax_xent_bwd_plain(logits, targets, lse, g)


fused_softmax_xent_bwd.launches = 0  # kernel launches since the last reset


# -------------------------------------------------------------- autograd


class _SoftmaxXent(torch.autograd.Function):
    """On the card only. The targets are checked once, in forward, and
    the backward launches on the checked copy it saved."""

    @staticmethod
    def forward(ctx, logits, targets):
        t32 = _checked_targets(logits, targets)
        loss, lse = _run_fwd(logits, t32)
        ctx.save_for_backward(logits, t32, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, t32, lse = ctx.saved_tensors
        return _run_bwd(logits, t32, lse, g), None


def fused_softmax_xent(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy, [..., V] logits x [...] targets → [...]
    fp32 losses (lse - target logit). CPU tensors take the plain version
    and its autograd; CUDA tensors the forward kernel and, in backward,
    the backward kernel. With no gradient to carry it is
    `fused_softmax_xent_fwd_only`."""
    if not _on_card("fused_softmax_xent", logits):
        return fused_softmax_xent_plain(logits, targets)
    if torch.is_grad_enabled() and logits.requires_grad:
        return _SoftmaxXent.apply(logits, targets)
    return fused_softmax_xent_fwd_only(logits, targets)


def fused_softmax_xent_fwd_only(logits: torch.Tensor,
                                targets: torch.Tensor) -> torch.Tensor:
    """Forward without residuals (eval paths): nothing is saved."""
    return fused_softmax_xent_fwd(logits, targets)[0]


class _ShiftedSoftmaxXent(torch.autograd.Function):
    """On the card only: the forward kernel over `logits[:, :-1]` by
    strides; the backward kernel writes the whole [B, T, V] gradient."""

    @staticmethod
    def forward(ctx, logits, targets):
        view = logits[:, :-1]
        t32 = _checked_targets(view, targets)
        loss, lse = _run_fwd(view, t32)
        ctx.save_for_backward(logits, t32, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, t32, lse = ctx.saved_tensors
        return _run_bwd_shifted(logits, t32, lse, g), None


def fused_softmax_xent_shifted(logits: torch.Tensor,
                               targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy: [B, T, V] logits x [B, T-1] targets →
    [B, T-1] fp32 losses, position t scored against targets[:, t] and
    position T-1 unscored — `fused_softmax_xent(logits[:, :-1],
    targets)`, whose gradient is that of the whole [B, T, V] tensor. On
    the card one backward launch writes it, the last position zero; CPU
    tensors take the plain version on the view and its autograd."""
    if logits.dim() != 3 or tuple(targets.shape) != (
            logits.shape[0], logits.shape[1] - 1):
        raise ValueError(f"fused_softmax_xent_shifted takes [B, T, V] "
                         f"logits and [B, T-1] targets, got "
                         f"{tuple(logits.shape)} and {tuple(targets.shape)}")
    if not _on_card("fused_softmax_xent_shifted", logits):
        return fused_softmax_xent_plain(logits[:, :-1], targets)
    if torch.is_grad_enabled() and logits.requires_grad:
        return _ShiftedSoftmaxXent.apply(logits, targets)
    return fused_softmax_xent_fwd_only(logits[:, :-1], targets)
