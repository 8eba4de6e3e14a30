"""Weight-only int8: the per-row quantizer and the int8 product with its
dequant epilogue — the hand-written CUDA kernels of
`csrc/int8_matmul.cu`, and their plain PyTorch versions.

Counterparts: `quantize_int8(x, axis=-1)`, `int8_matmul` and
`quantized_dense` of `hyperion_tpu/precision/quant.py` (`:47-62`,
`:69-85`, `:88-95`), which XLA computes there (no Pallas kernel). The
port's weights are [N, K] ([out, in]), so a weight's contraction axis
is its rows' axis too, and one per-row quantizer serves both the
activations and the weights (once, when a model is quantized).

  * `quantize_rows(x)`: x [..., K] (float32, bfloat16 or float16,
    contiguous) → (q int8 [..., K], scale float32 [...]), with
    scale = max(amax, 1e-8) / 127 and q = clip(round(x / scale), -127,
    127): fp32 amax, a true division, round half to even.
  * `int8_matmul(xq, wq, sx, sw, out_dtype, bias)`: xq [M, K] int8, wq
    [N, K] int8, sx [M] and sw [N] float32 → (float(acc) * sx) * sw
    rounded to `out_dtype` (float32 or bfloat16), then plus the bias
    rounded to that dtype; acc = xq · wqᵀ exact in int32.
  * `quantized_dense_decode(x, wq, sw, out_dtype, bias)`: the decode
    step's dense, M <= 16 float rows in one launch that quantizes its
    own rows: `quantize_rows` then `int8_matmul`, bit for bit.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA one, with no fallback: a failed build or launch
raises. The plain versions compute the same bits: on the CPU the
product accumulates in int32, on the card in float64, which is exact
for |acc| < 2**53 (at most K * 127**2 here), then cast to int32.
`int8_matmul_path`, `quantize_rows_path` and `kernel_attrs` say which
kernel a call takes (the rule lives here and in the C source alike;
the card's tests hold them equal) and what the compiler gave it.
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
# x, wq, sw, bias (may be null), out, M, N, K, in dtype, out dtype, stream
_DENSE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# which, in dtype, out dtype, K, N, out[6]
_ATTRS_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]
PATHS = ("decode_fused", "decode", "prefill_wgmma", "bytes")
QUANT_PATHS = ("scalar", "block")
KERNELS = ("quantize_scalar", "quantize_block",
           *PATHS)  # `kernel_attrs` names, in the C code's order
INT32_MAX = 2 ** 31 - 1
DECODE_MAX_M = 16        # the decode paths' rows
DECODE_MAX_K = 8 * 32 * 128  # the decode paths' K: 8 blocks of 32 boxes


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


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


def quantize_rows_path(x: torch.Tensor) -> str:
    """Which kernel `quantize_rows` launches for x [..., K]: "block" (a
    block a row of up to 4096 16-byte chunks, read once into registers,
    1 to 4 chunks a thread) or "scalar" (scalar loads, the row read
    twice) for rows off the 16-byte grid, K not whole chunks, or longer
    rows."""
    vec = 16 // x.element_size()
    K = x.shape[-1]
    if not _aligned(x) or K % vec:
        return "scalar"
    n = K // vec
    return "block" if n <= 4096 else "scalar"


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


def _check_mm(xq, wq, sx, sw, out_dtype, bias,
              what: str = "int8_matmul") -> tuple[int, int, int]:
    """The shapes and dtypes a product takes: `int8_matmul`'s int8 xq
    with its scales sx, or `quantized_dense_decode`'s float x (sx None)."""
    x_types = (torch.int8,) if sx is not None else tuple(_IN_DTYPES)
    if xq.dtype not in x_types or wq.dtype != torch.int8:
        raise TypeError(f"{what} takes {'int8' if sx is not None else 'float'}"
                        f" activations and int8 weights, got {xq.dtype} and "
                        f"{wq.dtype}")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"{what} takes x [M, K] and wq [N, K], got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    M, K = xq.shape
    N = wq.shape[0]
    if min(M, N, K) < 1 or max(M, N, K) > INT32_MAX:
        raise ValueError(f"{what} takes 1 <= M, N, K < 2**31, got "
                         f"M {M}, N {N}, K {K}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"{what} writes float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, v, n in (("sx", sx, M), ("sw", sw, N), ("bias", bias, N)):
        if v is None:
            continue
        if v.dtype != torch.float32 or v.numel() != n:
            raise ValueError(f"{name} must be float32 with {n} values, got "
                             f"{v.dtype} {tuple(v.shape)}")
    ts = [t for t in (xq, wq, sx, sw, bias) if t is not None]
    if any(t.device != xq.device for t in ts):
        raise ValueError(f"{what}: all inputs on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel needs contiguous inputs")
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


def fused_decode_takes(x: torch.Tensor, wq: torch.Tensor) -> bool:
    """Whether `quantized_dense_decode` takes x [M, K] (float32, bfloat16
    or float16, contiguous) against wq [N, K]: M <= 16, K a multiple of
    16 up to 32768, both on the 16-byte grid."""
    M, K = x.shape
    return (x.dtype in _IN_DTYPES and 1 <= M <= DECODE_MAX_M
            and K % 16 == 0 and K <= DECODE_MAX_K and _aligned(x)
            and _aligned(wq))


def int8_matmul_path(x: torch.Tensor, wq: torch.Tensor) -> str:
    """Which kernel a product launches. x int8 is `int8_matmul`'s xq:
    "decode" (M <= 16 and K <= 32768: a thread-block cluster splits K),
    "prefill_wgmma" (wgmma on TMA-fed tiles: every other M and K), both
    for K a multiple of 16 with both operands on the 16-byte grid, else
    "bytes" (mma.sync on byte loads). x float is `quantized_dense`'s
    activations: "decode_fused" where `fused_decode_takes`, else the
    path of its quantized rows (fresh, so on the grid)."""
    M, K = x.reshape(-1, x.shape[-1]).shape
    if x.dtype != torch.int8:
        if fused_decode_takes(x.reshape(M, K), wq):
            return "decode_fused"
        x_ok = True
    else:
        x_ok = _aligned(x)
    if not (x_ok and K % 16 == 0 and _aligned(wq)):
        return "bytes"
    return ("decode" if M <= DECODE_MAX_M and K <= DECODE_MAX_K
            else "prefill_wgmma")


def kernel_attrs(which: str, dtype: torch.dtype, K: int = 4096,
                 N: int = 4096) -> dict:
    """What the compiler gave a kernel (one of `KERNELS`): a quantizer
    at its input dtype (its widest instantiation), "decode_fused" at its
    input dtype (bfloat16 out), or "decode" / "prefill_wgmma" / "bytes"
    at their output dtype. Registers and local-memory (spill) bytes a
    thread, shared memory and threads a block, blocks a cluster and the
    clusters resident at once (the decode grids' size; 0 for the
    others); the decode kernels' at this K and N (the cluster size
    follows both). Needs the card."""
    fn = build.function("int8_matmul", "hyperion_int8_attrs",
                        _ATTRS_ARGTYPES)
    code = KERNELS.index(which)
    in_dt = _IN_DTYPES[dtype] if code <= 2 else 1
    out_dt = _OUT_DTYPES[dtype] if code > 2 else 1
    out = (ctypes.c_int * 6)()
    build.check(fn(code, in_dt, out_dt, K, N, out),
                "int8_matmul kernel attributes")
    return {"registers": out[0], "spill_bytes": out[1],
            "smem_bytes": out[2], "threads": out[3], "cluster": out[4],
            "clusters_resident": out[5]}


def c_paths(x: torch.Tensor, wq: torch.Tensor) -> tuple[str, str]:
    """The C source's own rules for x (as `int8_matmul_path` reads it)
    and, for a float x, its quantizer: what the card's tests hold the
    rules above to. Needs the card."""
    M, K = x.reshape(-1, x.shape[-1]).shape
    mm = build.function("int8_matmul", "hyperion_int8_matmul_path",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
    path = PATHS[mm(x.data_ptr(), wq.data_ptr(), M, K,
                    int(x.dtype != torch.int8))]
    if x.dtype == torch.int8:
        return path, ""
    qp = build.function("int8_matmul", "hyperion_quantize_rows_path",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
    return path, QUANT_PATHS[qp(x.data_ptr(), K, _IN_DTYPES[x.dtype])]


# ------------------------------------------------------ the decode dense


def quantized_dense_decode_plain(x: torch.Tensor, wq: torch.Tensor,
                                 sw: torch.Tensor,
                                 out_dtype=torch.bfloat16,
                                 bias: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """x [M, K] float → `quantize_rows_plain` then `int8_matmul_plain`:
    [M, N] in `out_dtype`."""
    xq, sx = quantize_rows_plain(x)
    return int8_matmul_plain(xq, wq, sx, sw, out_dtype, bias)


def _launch_dense_decode(x, wq, sw, out_dtype, bias) -> torch.Tensor:
    M, N, K = _check_mm(x, wq, None, sw, out_dtype, bias,
                        "quantized_dense_decode")
    if not fused_decode_takes(x, wq):
        raise ValueError(
            f"quantized_dense_decode kernel takes M <= {DECODE_MAX_M}, "
            f"K % 16 == 0, K <= {DECODE_MAX_K}, x and wq on the 16-byte "
            f"grid; got x {tuple(x.shape)} (use quantize_rows and "
            f"int8_matmul)")
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    fn = build.function("int8_matmul", "hyperion_quantized_dense_decode",
                        _DENSE_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), wq.data_ptr(), sw.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, N, K, _IN_DTYPES[x.dtype],
                    _OUT_DTYPES[out_dtype], _stream(x))
    build.check(status, "quantized_dense_decode launch")
    int8_matmul.launches += 1
    return out


def quantized_dense_decode(x: torch.Tensor, wq: torch.Tensor,
                           sw: torch.Tensor, out_dtype=torch.bfloat16,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """`quantized_dense` of a decode step in one launch: x [M, K] float
    (M <= 16), wq [N, K] int8 with per-row scales sw [N], optional
    float32 bias [N] → [M, N] in `out_dtype`, the bits of
    `quantize_rows` then `int8_matmul`. A launch counts as one
    `int8_matmul` launch and no `quantize_rows` one. CPU tensors take
    the plain version, CUDA tensors the kernel."""
    if x.device.type != "cuda":
        _check_mm(x, wq, None, sw, out_dtype, bias, "quantized_dense_decode")
        return quantized_dense_decode_plain(x, wq, sw, out_dtype, bias)
    return _launch_dense_decode(x, wq, sw, out_dtype, bias)
