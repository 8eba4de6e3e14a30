"""Symmetric int8 quantization — `hyperion_tpu/precision/quant.py` in
PyTorch.

Weight-only int8 inference: every dense kernel of a model becomes an
int8 weight with a float32 scale per output feature; activations are
quantized per row at run time, multiplied in int8 with an exact int32
sum, and dequantized in the product's epilogue. On the card that is the
two kernels of `ops/int8_matmul.py` (`csrc/int8_matmul.cu`); on the
CPU their plain versions, bit for bit the same.

  * `quantize_int8(x, axis)`: symmetric per-axis quantization, the
    reference's arithmetic — fp32 amax, scale = max(amax, 1e-8) / 127,
    q = clip(round(x / scale), -127, 127) with a true division and
    round half to even. Returns (q int8 like x, scale fp32 with `axis`
    kept as size 1). Over the last axis alone it is
    `ops.int8_matmul.quantize_rows` (the kernel on the card).
  * `dequantize`, `int8_matmul`, `quantized_dense`: as the reference's,
    in the port's [N, K] ([out, in]) weight layout; the epilogue is
    `(acc * sx) * sw` in fp32, cast to the output dtype, then the bias
    cast to that dtype is added.
  * `QuantDense`: the `QuantDenseGeneral` counterpart — an int8
    `weight_q` [N, K] and a float32 `weight_scale` [N] (buffers: they
    carry no gradient), and a float32 `bias` [N] that adds after the
    dequant. `make_dense` is the models' dispatch: `QuantDense` when the
    config's `quant` is "int8", the model's float dense otherwise
    (configs without a `quant` field, the MoE LM's, stay float).
  * `quantize_params_like`, `quantize_llama`, `quantize_lm`,
    `dequantize_params`: a float state dict (the port's names, from
    `params_from_jax` or a model) to the int8 layout and back.
    Embeddings, norms and biases stay float. A weight quantizes on the
    device of the model it goes into: on the card, through the kernel.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hyperion_tpu_torch.ops.int8_matmul import int8_matmul as _int8_matmul
from hyperion_tpu_torch.ops.int8_matmul import quantize_rows, scale_of

QUANT_MODES = ("none", "int8")


def quantize_int8(x: torch.Tensor, axis: int | tuple[int, ...] = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-axis int8 quantization over the contraction axis
    (or axes) `axis`: (q int8 shaped like x, scale fp32 shaped like x
    with `axis` reduced to 1), q * scale ≈ x."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(sorted(a % x.dim() for a in axes))
    if axes == (x.dim() - 1,):
        q, scale = quantize_rows(x.contiguous())
        return q, scale.unsqueeze(-1)
    h = x.float()
    scale = scale_of(h.abs().amax(dim=axes, keepdim=True))
    q = torch.round(h / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """`dequant(xq) @ dequant(wq)ᵀ` as an int8 product: xq [..., M, K]
    with per-row scales sx [..., M] (or [..., M, 1]), wq [N, K] with
    per-row scales sw [N] (or [1, N]) → [..., M, N] in `out_dtype`."""
    lead = xq.shape[:-1]
    out = _int8_matmul(xq.reshape(-1, xq.shape[-1]).contiguous(),
                       wq.contiguous(), sx.reshape(-1).float().contiguous(),
                       sw.reshape(-1).float().contiguous(), out_dtype,
                       None if bias is None else bias.float().contiguous())
    return out.reshape(*lead, wq.shape[0])


def quantized_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                    out_dtype: torch.dtype | None = None,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Drop-in `x @ w.T (+ bias)` with a pre-quantized weight wq [N, K]:
    per-row activation quantization, the int8 product, float out."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    xq, sx = quantize_rows(x2)
    out = _int8_matmul(xq, wq, sx, sw, out_dtype or x.dtype, bias)
    return out.reshape(*lead, wq.shape[0])


class QuantDense(nn.Module):
    """A dense layer reading an int8 weight: `weight_q` [d_out, d_in]
    int8 and `weight_scale` [d_out] fp32 (zeros and ones until a
    quantized state is loaded, as the reference's placeholders), an
    optional fp32 `bias` added after the dequant. Output in `dtype`."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device,
                 bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            d_out, d_in, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            d_out, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) \
            if bias else None

    def forward(self, x):
        return quantized_dense(x, self.weight_q, self.weight_scale,
                               self.dtype, self.bias)


def check_quant(mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r} (want one of "
                         f"{QUANT_MODES})")


def make_dense(cfg, float_cls, d_in: int, d_out: int, device, *,
               use_bias: bool = False) -> nn.Module:
    """The models' dense dispatch: `QuantDense` when `cfg.quant` is
    "int8", else `float_cls(d_in, d_out, cfg.compute_dtype, device)`.
    Configs with no `quant` field stay float."""
    mode = getattr(cfg, "quant", "none")
    check_quant(mode)
    if mode == "int8":
        return QuantDense(d_in, d_out, cfg.compute_dtype, device,
                          bias=use_bias)
    return float_cls(d_in, d_out, cfg.compute_dtype, device)


def _state(params) -> dict[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, nn.Module) \
        else dict(params)


def quantize_params_like(params, qmodel: nn.Module
                         ) -> dict[str, torch.Tensor]:
    """A float state dict (or a model) in the layout of `qmodel`, the
    same architecture with int8 dense layers: wherever `qmodel` has a
    `QuantDense`, the float `<name>.weight` [N, K] becomes
    `<name>.weight_q` and `<name>.weight_scale`, quantized per row (its
    contraction axis) on `qmodel`'s device. Everything else passes
    through."""
    targets = {name: m for name, m in qmodel.named_modules()
               if isinstance(m, QuantDense)}
    out = {}
    for key, v in _state(params).items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight" and mod in targets:
            want = tuple(targets[mod].weight_q.shape)
            if tuple(v.shape) != want:
                raise ValueError(f"{key}: kernel shape {tuple(v.shape)} != "
                                 f"quant model's {want}")
            q, s = quantize_rows(v.to(targets[mod].weight_q.device))
            out[f"{mod}.weight_q"], out[f"{mod}.weight_scale"] = q, s
        else:
            out[key] = v
    return out


def quantize_for(qmodel: nn.Module, params) -> nn.Module:
    """Load `params` (float) into `qmodel` through
    `quantize_params_like`; returns `qmodel`."""
    qmodel.load_state_dict(quantize_params_like(params, qmodel), strict=True)
    return qmodel


def _device_of(params, device):
    if device is not None:
        return device
    return next(iter(_state(params).values())).device


def quantize_llama(params, cfg, device=None):
    """Weight-only int8 for a Llama: `(quant_model, quant_state)`, the
    model built at `cfg` with `quant="int8"` on `device` (default: where
    `params` are) and loaded; `params` is the float state dict (or
    model) of `models.llama.Llama(cfg)`."""
    from hyperion_tpu_torch.models.llama import Llama  # avoid a cycle

    qmodel = Llama(dataclasses.replace(cfg, quant="int8"),
                   device=_device_of(params, device))
    quantize_for(qmodel, params)
    return qmodel, qmodel.state_dict()


def quantize_lm(params, cfg, device=None):
    """Weight-only int8 for a TransformerLM (the recompute generation
    path): the same contract as `quantize_llama`."""
    from hyperion_tpu_torch.models.transformer_lm import TransformerLM

    qmodel = TransformerLM(dataclasses.replace(cfg, quant="int8"),
                           device=_device_of(params, device))
    quantize_for(qmodel, params)
    return qmodel, qmodel.state_dict()


def dequantize_params(qparams, dtype: torch.dtype = torch.bfloat16
                      ) -> dict[str, torch.Tensor]:
    """Invert `quantize_params_like` (up to quantization error): each
    `weight_q`/`weight_scale` pair folds back into a float `weight`."""
    state = _state(qparams)
    out = {}
    for key, v in state.items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight_q":
            out[f"{mod}.weight"] = dequantize(
                v, state[f"{mod}.weight_scale"][:, None], dtype)
        elif leaf != "weight_scale":
            out[key] = v
    return out
