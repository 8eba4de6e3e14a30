"""Compilation tiers: eager ops against one CUDA graph against the hand
kernels — `hyperion_tpu/bench/compile_bench.py` on the card.

The reference's tiers keep their names, so the CSVs compare:

  op_by_op    eager plain PyTorch ops, one host dispatch a kernel, timed
              per call on the host clock (the dispatch is what the tier
              shows);
  jit         the same plain ops captured once into a CUDA graph and
              replayed (`utils.timing.time_chained(graph=True)`), the
              port's compile tier since the serve engine's
              `serve/graphs.py`;
  jit_pallas  the capture with the hand kernels: flash attention and the
              fused LayerNorm (transformer_lm) or RMSNorm (llama). ResNet
              has neither: its row repeats the jit number, flagged
              `same_as_jit`.

There is no `torch.compile` tier: the reference has none either.
`--train-step` times a full forward + backward + AdamW step of the
GPT-2-shaped LM at seq 1024, jit against jit_pallas (eager between CUDA
events; its attention and loss at "xla" or "pallas"). `temp_memory_gb`
is the allocator's peak above the resident state over a tier's run; the
card has no per-program analysis like XLA's.

    python -m hyperion_tpu_torch.bench.compile_bench [--dtype bf16]
        [--repeat N] [--train-step] [--train-seq 1024] [--out DIR]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
from pathlib import Path

import numpy as np
import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.bench.util import write_csv
from hyperion_tpu_torch.models.resnet import resnet18
from hyperion_tpu_torch.models.transformer_lm import (
    TransformerLM,
    gpt2_lm_config,
)
from hyperion_tpu_torch.utils.timing import time_chained, time_fn


def _seeded(model):
    return model.init_params(torch.Generator(device=model.device)
                             .manual_seed(0))


def _ids(batch: int, seq: int, vocab: int, dev) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (batch, seq)), device=dev)


def _lm_spec(dtype: str, pallas: bool, device):
    impl = "pallas" if pallas else "xla"
    model = _seeded(TransformerLM(gpt2_lm_config(
        dropout=0.0, dtype=dtype, attention_impl=impl, norm_impl=impl),
        device=device))
    return model, _ids(32, 128, 50257, model.device)


def _llama_spec(dtype: str, pallas: bool, device):
    """A GPT-2-sized Llama stack: the fused-RMSNorm data point."""
    from hyperion_tpu_torch.models.llama import Llama, LlamaConfig

    impl = "pallas" if pallas else "xla"
    model = _seeded(Llama(LlamaConfig(
        vocab_size=32000, d_model=768, n_layers=4, n_heads=12,
        n_kv_heads=12, ff_dim=3072, max_len=512, remat=False, dtype=dtype,
        attention_impl=impl, norm_impl=impl), device=device))
    return model, _ids(8, 512, 32000, model.device)


class _Eval(torch.nn.Module):
    """ResNet-18 at inference on NHWC images."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x.permute(0, 3, 1, 2), train=False)


def _resnet_spec(dtype: str, pallas: bool, device):
    model = _seeded(resnet18(num_classes=1000, cifar_stem=False, dtype=dtype,
                             device=device))
    return _Eval(model), torch.zeros(32, 224, 224, 3, device=model.device)


MODEL_SPECS = {
    "transformer_lm": _lm_spec,
    "llama": _llama_spec,
    "resnet18": _resnet_spec,
}
VARIANTS = ("op_by_op", "jit", "jit_pallas")


def _free(dev) -> None:
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def bench_variant(name: str, variant: str, dtype: str, iters: int,
                  device=None) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    model, x = MODEL_SPECS[name](dtype, variant == "jit_pallas", dev)
    note = "same_as_jit" if name == "resnet18" and variant == "jit_pallas" \
        else ""

    def apply(x):
        with torch.no_grad():
            return model(x)

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    if variant == "op_by_op":
        it = max(3, iters // 4)
        t = time_fn(apply, x, warmup=2, iters=it)
        mean_ms, median_ms = t.mean_ms, t.median_ms
    else:
        it = max(6, min(iters, 16))
        t = time_chained(apply, x, k1=max(2, it // 3), k2=it, graph=cuda)
        mean_ms = median_ms = t.per_iter_ms
    temp_gb = (round((torch.cuda.max_memory_allocated(dev) - base) / 1e9, 4)
               if cuda else float("nan"))
    del model, x
    _free(dev)
    return {"model": name, "variant": variant, "dtype": dtype,
            "mean_ms": round(mean_ms, 3), "median_ms": round(median_ms, 3),
            "temp_memory_gb": temp_gb, "iters": it, "note": note}


def _failed(model: str, variant: str, dtype: str, e: Exception) -> dict:
    return {"model": model, "variant": variant, "dtype": dtype,
            "mean_ms": float("nan"), "median_ms": float("nan"),
            "temp_memory_gb": float("nan"), "iters": 0,
            "note": f"failed: {str(e).splitlines()[0][:80]}"}


def run(models, dtype: str, iters: int, sink=None, device=None) -> list[dict]:
    rows = []
    for name in models:
        for variant in VARIANTS:
            try:
                r = bench_variant(name, variant, dtype, iters, device)
            except Exception as e:  # noqa: BLE001 — per-variant tolerance
                r = _failed(name, variant, dtype, e)
                _free(resolve_device(device))
            rows.append(r)
            if sink is not None:
                sink(r)
            print(f"[compile_bench] {json.dumps(r)}")
    return rows


def train_step_rows(dtype: str, seq: int = 1024, batch: int = 4, sink=None,
                    device=None) -> list[dict]:
    """A full train step (forward, backward, AdamW) at long sequence, jit
    against jit_pallas: the regime where flash attention's O(T) memory
    against the [B, H, T, T] scores shows in time and memory."""
    from hyperion_tpu_torch.train.losses import next_token_loss
    from hyperion_tpu_torch.train.state import make_optimizer

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rows = []
    for variant in ("jit", "jit_pallas"):
        impl = "pallas" if variant == "jit_pallas" else "xla"
        name = f"transformer_lm_seq{seq}_train"
        try:
            model = _seeded(TransformerLM(gpt2_lm_config(
                dropout=0.0, dtype=dtype, max_len=seq, attention_impl=impl,
                norm_impl=impl), device=dev))
            opt = make_optimizer(model.parameters(), 2e-4, grad_clip_norm=1.0)
            ids = _ids(batch, seq, 50257, dev)

            def step(ids):
                opt.zero_grad()
                loss = next_token_loss(model(ids), ids, impl=impl)
                loss.backward()
                opt.step()
                return loss.detach()

            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            t = time_chained(step, ids, k1=2, k2=6)
            rows.append({
                "model": name, "variant": variant, "dtype": dtype,
                "mean_ms": round(t.per_iter_ms, 3),
                "median_ms": round(t.per_iter_ms, 3),
                "temp_memory_gb": (round((torch.cuda.max_memory_allocated(
                    dev) - base) / 1e9, 4) if cuda else float("nan")),
                "iters": t.k2, "note": ""})
            del model, opt
        except Exception as e:  # noqa: BLE001 — per-variant tolerance
            rows.append(_failed(name, variant, dtype, e))
        _free(dev)
        if sink is not None:
            sink(rows[-1])
        print(f"[compile_bench] {json.dumps(rows[-1])}")
    return rows


def summarize(rows: list[dict]) -> str:
    lines = ["compilation tier analysis", "=" * 40]
    for model in sorted({r["model"] for r in rows}):
        sub = {r["variant"]: r for r in rows if r["model"] == model}
        base = sub.get("jit", {}).get("median_ms")
        lines.append(f"\n{model}:")
        for variant in VARIANTS:
            r = sub.get(variant)
            if r is None:
                continue
            if r["median_ms"] != r["median_ms"]:
                lines.append(f"  {variant:>10}: failed")
                continue
            speed = (base / r["median_ms"]) if base else float("nan")
            mem = r.get("temp_memory_gb")
            mem_s = (f"  temp {mem:.3f} GB"
                     if isinstance(mem, (int, float)) and mem == mem else "")
            lines.append(f"  {variant:>10}: {r['median_ms']:9.3f} ms"
                         f"  ({speed:.2f}x vs jit){mem_s} {r['note']}")
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", nargs="*", default=list(MODEL_SPECS))
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--repeat", type=int, default=20)
    p.add_argument("--train-step", action="store_true",
                   help="add the long-seq train-step jit-vs-pallas rows")
    p.add_argument("--train-seq", type=int, default=1024)
    p.add_argument("--train-batch", type=int, default=4)
    p.add_argument("--out", default="results/torch/benchmarks/compilation")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dtype = {"fp32": "float32", "bf16": "bfloat16"}[args.dtype]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    flushed: list[dict] = []

    def sink(row: dict) -> None:
        flushed.append(row)
        write_csv(out / "compilation_benchmark.csv", flushed)
        (out / "compilation_benchmark.json").write_text(
            json.dumps(flushed, indent=2))

    rows = run(args.models, dtype, args.repeat, sink=sink, device=args.device)
    if args.train_step:
        rows += train_step_rows(dtype, args.train_seq, args.train_batch,
                                sink=sink, device=args.device)
    from hyperion_tpu_torch.metrics.plots import plot_compile_tiers, try_plot

    try_plot(plot_compile_tiers, rows, out / "compilation_benchmark.png")
    text = summarize(rows)
    (out / "compilation_analysis.txt").write_text(text)
    print(text)


if __name__ == "__main__":
    main()
