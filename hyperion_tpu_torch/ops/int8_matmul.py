"""Weight-only int8: the per-row quantizer and the int8 product with its
dequant epilogue — the hand-written CUDA kernels of
`csrc/int8_matmul.cu`, and their plain PyTorch versions.

Counterparts: `quantize_int8(x, axis=-1)` and `int8_matmul` of
`hyperion_tpu/precision/quant.py` (`:47-62`, `:69-85`), which XLA
computes there (no Pallas kernel). The port's weights are [N, K]
([out, in]), so a weight's contraction axis is its rows' axis too, and
one per-row quantizer serves both the activations (at every dense call)
and the weights (once, when a model is quantized).

  * `quantize_rows(x)`: x [..., K] (float32, bfloat16 or float16,
    contiguous) → (q int8 [..., K], scale float32 [...]), with
    scale = max(amax, 1e-8) / 127 and q = clip(round(x / scale), -127,
    127): fp32 amax, a true division, round half to even.
  * `int8_matmul(xq, wq, sx, sw, out_dtype, bias)`: xq [M, K] int8, wq
    [N, K] int8, sx [M] and sw [N] float32 → (float(acc) * sx) * sw
    rounded to `out_dtype` (float32 or bfloat16), then plus the bias
    rounded to that dtype; acc = xq · wqᵀ exact in int32.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA one, with no fallback: a failed build or launch
raises. The plain versions compute the same bits: on the CPU the
product accumulates in int32, on the card in float64, which is exact
for |acc| < 2**53 (at most K * 127**2 here), then cast to int32.
`int8_matmul_path` and `kernel_attrs` say which kernel a call takes
and what the compiler gave it.
"""

from __future__ import annotations

import ctypes

import torch

from hyperion_tpu_torch.ops import build

EPS = 1e-8
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, q, scale, rows, K, dtype, stream
_QUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
# xq, wq, sx, sw, bias (may be null), out, M, N, K, out dtype, stream
_MM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ATTRS_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PATHS = {0: "decode", 1: "prefill"}
INT32_MAX = 2 ** 31 - 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ------------------------------------------------------------ quantizer


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as a true division. The divisor is a
    tensor: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which rounds differently (one ulp, for a few percent of
    values)."""
    return amax.clamp_min(EPS) / torch.full_like(amax, 127.0)


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] → (q int8 [..., K], scale float32 [...])."""
    h = x.float()
    scale = scale_of(h.abs().amax(dim=-1))
    q = torch.round(h / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _launch_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"quantize_rows kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0 or not x.is_contiguous():
        raise ValueError(f"quantize_rows kernel takes a contiguous x "
                         f"[..., K] with K >= 1, got {tuple(x.shape)}")
    K = x.shape[-1]
    rows = x.numel() // K
    if K > INT32_MAX or rows > INT32_MAX:
        raise ValueError(f"quantize_rows kernel takes K and rows below "
                         f"2**31, got K {K}, rows {rows}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    fn = build.function("int8_matmul", "hyperion_quantize_rows",
                        _QUANT_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, K,
                    _IN_DTYPES[x.dtype], _stream(x))
    build.check(status, "quantize_rows launch")
    quantize_rows.launches += 1
    return q, scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of x [..., K] over its last
    axis: (q int8 [..., K], scale float32 [...]), q * scale ≈ x. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if x.device.type != "cuda":
        return quantize_rows_plain(x)
    return _launch_quantize(x)


quantize_rows.launches = 0  # kernel launches since the last reset


# -------------------------------------------------------------- product


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                      sw: torch.Tensor, out_dtype=torch.bfloat16,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """xq [M, K] int8 · wq [N, K]ᵀ int8 → [M, N] in `out_dtype`:
    (float(acc) * sx[m]) * sw[n], rounded, plus bias[n] rounded."""
    if xq.device.type == "cuda":
        acc = (xq.double() @ wq.double().T).to(torch.int32)
    else:
        acc = xq.int() @ wq.int().T
    out = (acc.float() * sx.float().reshape(-1, 1)
           * sw.float().reshape(1, -1)).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def _check_mm(xq, wq, sx, sw, out_dtype, bias) -> tuple[int, int, int]:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {xq.dtype} "
                        f"and {wq.dtype}")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_matmul takes xq [M, K] and wq [N, K], got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    M, K = xq.shape
    N = wq.shape[0]
    if min(M, N, K) < 1 or max(M, N, K) > INT32_MAX:
        raise ValueError(f"int8_matmul takes 1 <= M, N, K < 2**31, got "
                         f"M {M}, N {N}, K {K}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul writes float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, v, n in (("sx", sx, M), ("sw", sw, N), ("bias", bias, N)):
        if v is None:
            continue
        if v.dtype != torch.float32 or v.numel() != n:
            raise ValueError(f"{name} must be float32 with {n} values, got "
                             f"{v.dtype} {tuple(v.shape)}")
    ts = [t for t in (xq, wq, sx, sw, bias) if t is not None]
    if any(t.device != xq.device for t in ts):
        raise ValueError("int8_matmul: all inputs on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("int8_matmul kernel needs contiguous inputs")
    return M, N, K


def _launch_mm(xq, wq, sx, sw, out_dtype, bias) -> torch.Tensor:
    M, N, K = _check_mm(xq, wq, sx, sw, out_dtype, bias)
    out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
    fn = build.function("int8_matmul", "hyperion_int8_matmul", _MM_ARGTYPES)
    with torch.cuda.device(xq.device):
        status = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, N, K, _OUT_DTYPES[out_dtype],
                    _stream(xq))
    build.check(status, "int8_matmul launch")
    int8_matmul.launches += 1
    return out


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, out_dtype=torch.bfloat16,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """`dequant(xq) · dequant(wq)ᵀ` as an int8 product: xq [M, K] with
    per-row scales sx [M], wq [N, K] with per-row scales sw [N] (any
    M, N, K >= 1), optional float32 bias [N] → [M, N] in `out_dtype`.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if xq.device.type != "cuda":
        _check_mm(xq, wq, sx, sw, out_dtype, bias)
        return int8_matmul_plain(xq, wq, sx, sw, out_dtype, bias)
    return _launch_mm(xq, wq, sx, sw, out_dtype, bias)


int8_matmul.launches = 0  # kernel launches since the last reset


def int8_matmul_path(M: int) -> str:
    """Which tile `int8_matmul` launches for M rows: "decode" (M <= 16:
    16 x 32 output tiles, K split over 4 warps) or "prefill" (64 x 128).
    The C entry point's own rule; needs the card."""
    fn = build.function("int8_matmul", "hyperion_int8_matmul_path",
                        [ctypes.c_int])
    return _PATHS[fn(M)]


def kernel_attrs(which: str, dtype: torch.dtype, vec: bool = True) -> dict:
    """What the compiler gave a kernel: "quantize_rows" at its input
    dtype, or the product's "decode" / "prefill" tile at its output
    dtype, streaming by cp.async (`vec`) or by bytes. Registers and
    local-memory (spill) bytes a thread, shared memory and threads a
    block. Needs the card."""
    fn = build.function("int8_matmul", "hyperion_int8_attrs",
                        _ATTRS_ARGTYPES)
    code = {"quantize_rows": 0, "decode": 1, "prefill": 2}[which]
    table = _IN_DTYPES if code == 0 else _OUT_DTYPES
    out = (ctypes.c_int * 4)()
    build.check(fn(code, table[dtype], int(vec), out),
                "int8_matmul kernel attributes")
    return {"registers": out[0], "spill_bytes": out[1],
            "smem_bytes": out[2], "threads": out[3]}
