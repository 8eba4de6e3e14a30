"""Baseline model benchmarks: forward, backward and optimizer time, batch
scaling, precisions — `hyperion_tpu/bench/baseline.py` on the card.

The reference times forward, forward+backward and the full train step
separately (backward = t(fwd+bwd) - t(fwd), optimizer = t(step) -
t(fwd+bwd)), with peak memory and samples/s, for four subjects:
ResNet-50, ViT-B/16, the reference's real "ViT" subject
(`_RefFallbackCNN`, the ~100K-parameter CNN its torchvision build fell
back to) and the custom encoder at seq 16 with an MSE loss. Each program
is a chain of iterations between CUDA events (`utils.timing.
time_chained`: the slope of two chain lengths, fixed overhead out), the
train step Adam(1e-3) as the reference's optax.adam. Peak memory is the
allocator's peak (`torch.cuda.max_memory_allocated`) over the row, its
counter reset first.

The batch-size sweep records an out-of-memory batch as a row with
status "oom" and stops there; nothing else is caught.

    python -m hyperion_tpu_torch.bench.baseline [--models ...]
        [--batch-size 32] [--dtype bfloat16] [--scaling]
        [--precisions float32 bfloat16] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import math
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.bench.util import write_csv as _write_csv
from hyperion_tpu_torch.models.encoder import (
    TransformerEncoder,
    custom_transformer_config,
)
from hyperion_tpu_torch.models.resnet import resnet50
from hyperion_tpu_torch.models.vit import ViT, vit_b16_config
from hyperion_tpu_torch.utils.timing import time_chained


def _lecun_(p: torch.Tensor, fan_in: int, generator) -> None:
    """flax's lecun_normal: a normal truncated at 2 sigma."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)


class _RefFallbackCNN(nn.Module):
    """The reference's ACTUAL "ViT" benchmark subject: conv 7x7/2 (64)
    -> relu -> max-pool 3/2 -> conv 3x3 (128) -> relu -> max-pool 3/2
    -> global average pool -> linear 128 -> 1000. NHWC images in; the
    flax auto-names of the JAX module (`Conv_0`, `Conv_1`, `Dense_0`)."""

    def __init__(self, dtype: str = "bfloat16", *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.device = dev
        self.dtype = getattr(torch, dtype)
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, device=dev)
        self.Conv_1 = nn.Conv2d(64, 128, 3, padding=1, device=dev)
        self.Dense_0 = nn.Linear(128, 1000, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "_RefFallbackCNN":
        for mod in (self.Conv_0, self.Conv_1, self.Dense_0):
            _lecun_(mod.weight, mod.weight[0].numel(), generator)
            mod.bias.zero_()
        return self

    def forward(self, x):
        dt = self.dtype
        x = torch.as_tensor(x, device=self.device).to(dt).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        for conv in (self.Conv_0, self.Conv_1):
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                stride=conv.stride, padding=conv.padding))
            x = F.max_pool2d(x, 3, 2, padding=1)
        x = x.mean((2, 3))
        return F.linear(x, self.Dense_0.weight.to(dt),
                        self.Dense_0.bias.to(dt)).float()


def ref_cnn_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The flax fallback CNN's params (numpy) as `_RefFallbackCNN`'s
    state dict: conv kernels HWIO -> OIHW, the dense kernel [in, out] ->
    [out, in]."""
    sd = {}
    for name, node in tree.items():
        k = np.asarray(node["kernel"], np.float32)
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(node["bias"], np.float32).copy())
    return sd


def _seeded(model):
    return model.init_params(torch.Generator(device=model.device)
                             .manual_seed(0))


def _images(batch: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(batch, 224, 224, 3, device=dev),
            torch.zeros(batch, dtype=torch.long, device=dev))


def _resnet50_spec(batch: int, dtype: str, device):
    model = _seeded(resnet50(num_classes=1000, dtype=dtype, device=device))
    x, y = _images(batch, model.device)

    def apply(x):
        return model(x.permute(0, 3, 1, 2), train=True)

    return model, apply, (x, y)


def _vit_spec(batch: int, dtype: str, device):
    model = _seeded(ViT(vit_b16_config(dtype=dtype), device=device))
    return model, model, _images(batch, model.device)


def _vit_fallback_cnn_spec(batch: int, dtype: str, device):
    model = _seeded(_RefFallbackCNN(dtype, device=device))
    return model, model, _images(batch, model.device)


def _custom_transformer_spec(batch: int, dtype: str, device, seq: int = 16):
    model = _seeded(TransformerEncoder(
        custom_transformer_config(dropout=0.0, dtype=dtype), device=device))
    x = torch.zeros(batch, seq, 512, device=model.device)
    y = torch.zeros(batch, seq, 512, device=model.device)  # MSE target
    return model, model, (x, y)


MODEL_SPECS: dict[str, Callable] = {
    "resnet50": _resnet50_spec,
    "vit_b16": _vit_spec,
    "vit_fallback_cnn": _vit_fallback_cnn_spec,
    "custom_transformer": _custom_transformer_spec,
}


def benchmark_model(name: str, batch: int, dtype: str = "bfloat16",
                    iters: int = 20, warmup: int = 5,
                    static_memory: bool = True, device=None) -> dict:
    """One row of the reference's `model_benchmarks.csv`."""
    del warmup, static_memory  # chains warm themselves; the allocator
    # counts memory on the card
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model, apply, (x, y) = MODEL_SPECS[name](batch, dtype, dev)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=1e-3)

    def loss_fn(x, y):
        out = apply(x)
        if out.dim() == 2 and y.dim() == 1:  # classification
            return F.cross_entropy(out.float(), y)
        return ((out - y) ** 2).mean()  # the reference's MSE

    def fwd(x, y):
        with torch.no_grad():
            return loss_fn(x, y)

    def fwd_bwd(x, y):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(x, y)
        loss.backward()
        return loss.detach()

    def full_step(x, y):
        loss = fwd_bwd(x, y)
        opt.step()
        return loss

    k2 = max(6, min(iters, 16))
    k1 = max(2, k2 // 3)
    t_fwd = time_chained(fwd, x, y, k1=k1, k2=k2)
    t_bwd = time_chained(fwd_bwd, x, y, k1=k1, k2=k2)
    t_full = time_chained(full_step, x, y, k1=k1, k2=k2)
    # decomposition by subtraction, clamped at 0
    fwd_ms = t_fwd.per_iter_ms
    bwd_ms = max(t_bwd.per_iter_ms - fwd_ms, 0.0)
    opt_ms = max(t_full.per_iter_ms - t_bwd.per_iter_ms, 0.0)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    row = {
        "model": name,
        "batch_size": batch,
        "dtype": dtype,
        "forward_ms": round(fwd_ms, 3),
        "backward_ms": round(bwd_ms, 3),
        "optimizer_ms": round(opt_ms, 3),
        "total_ms": round(t_full.per_iter_ms, 3),
        "peak_memory_mb": round(peak / 1e6, 2),
        "memory_source": "allocator_peak" if cuda else "unavailable",
        "samples_per_s": round(t_full.throughput(batch), 2),
        "dispatch_overhead_ms": round(t_full.overhead_ms, 2),
    }
    del model, opt, params
    return row


def batch_size_scaling(name: str, batch_sizes=(1, 2, 4, 8, 16, 32, 64),
                       dtype: str = "bfloat16", iters: int = 10, sink=None,
                       device=None) -> list[dict]:
    """The reference's `test_batch_size_scaling`: sweep up, and at the
    first batch that does not fit record it with status "oom" and stop."""
    rows = []
    for bs in batch_sizes:
        try:
            rows.append(benchmark_model(name, bs, dtype, iters=iters,
                                        warmup=3, static_memory=False,
                                        device=device))
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).splitlines()[0][:120]
            print(f"[baseline] {name} bs={bs}: stopping sweep ({msg})")
            rows.append({"model": name, "batch_size": bs, "dtype": dtype,
                         "status": "oom", "note": msg})
            gc.collect()
            torch.cuda.empty_cache()
            if sink is not None:
                sink(rows)
            break
        if sink is not None:
            sink(rows)
    return rows


def precision_comparison(name: str, batch: int = 32,
                         dtypes=("float32", "bfloat16"), iters: int = 10,
                         device=None) -> list[dict]:
    """The reference's `compare_precision_formats`."""
    return [benchmark_model(name, batch, dt, iters=iters, device=device)
            for dt in dtypes]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", nargs="*", default=list(MODEL_SPECS))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--scaling", action="store_true",
                   help="also run the batch-size scaling sweep")
    p.add_argument("--precisions", nargs="*", default=None,
                   help="also sweep these dtypes per model, e.g. float32 "
                        "bfloat16")
    p.add_argument("--batch-sizes", type=int, nargs="*",
                   default=[1, 2, 4, 8, 16, 32, 64])
    p.add_argument("--out", default="results/torch/benchmarks/baseline")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from hyperion_tpu_torch.metrics.plots import (
        plot_baseline_models,
        plot_batch_scaling,
        try_plot,
    )

    dev = args.device
    out = Path(args.out)
    rows = []
    for name in args.models:
        r = benchmark_model(name, args.batch_size, args.dtype,
                            iters=args.iters, device=dev)
        rows.append(r)
        _write_csv(out / "model_benchmarks.csv", rows)
        print(f"[baseline] {json.dumps(r)}")
    try_plot(plot_baseline_models, rows, out / "model_benchmarks.png")

    if args.precisions:
        by_model = {r["model"]: r for r in rows}
        prec_rows = []
        for name in args.models:
            for dt in args.precisions:
                if dt == args.dtype and name in by_model:
                    prec_rows.append(by_model[name])  # already measured
                else:
                    prec_rows.append(benchmark_model(
                        name, args.batch_size, dt, iters=args.iters,
                        device=dev))
                _write_csv(out / "precision_comparison.csv", prec_rows)
        for r in prec_rows:
            print(f"[baseline] precision {json.dumps(r)}")

    if args.scaling:
        sweeps = {}
        for name in args.models:
            sweep = batch_size_scaling(
                name, args.batch_sizes, args.dtype, device=dev,
                sink=lambda rows, p=out / f"{name}_batch_scaling.csv":
                    _write_csv(p, rows))
            sweeps[name] = sweep
            for r in sweep:
                print(f"[baseline] scaling {json.dumps(r)}")
        try_plot(plot_batch_scaling,
                 {k: [r for r in v if r.get("status") != "oom"]
                  for k, v in sweeps.items() if v},
                 out / "batch_scaling.png")
    print(f"[baseline] results in {out}/")


if __name__ == "__main__":
    main()
