"""Decode benchmark: prefill latency and per-token decode throughput,
float and weight-only int8 — `hyperion_tpu/bench/decode_bench.py` on
the card.

Per model size, the KV-cache decode path of `infer.generate`: a prefill
(one forward over the prompt into a fresh cache, timed per call on the
host clock, synchronised), then a chain of one-token decode steps, each
step's cache write and argmax feeding the next (`utils.timing.
time_chained`, each chain one CUDA graph replayed between CUDA events:
the host's dispatch is out of the per-token number, as the reference's
jitted chain keeps it out). `--quant int8` quantizes the model on the
card (`precision.quant.quantize_llama`, the `quantize_rows` kernel) and
decodes through the `int8_matmul` kernel: half bf16's weight bytes,
which bound decode.

`--speculative` adds batch-1 whole-generation rows (`generate` against
`generate_speculative` with the target as its own draft, the ceiling,
and with `--spec-draft` a smaller model as a real draft) and the
breakeven acceptance rate from measured per-forward times
(`spec_breakeven_acceptance`). Memory: the allocator's live bytes after
the chain and its peak over the row (counter reset first).

    python -m hyperion_tpu_torch.bench.decode_bench [--models tiny mid]
        [--quant none int8] [--batch 8] [--prompt-len 128]
        [--decode-len 64] [--speculative] [--spec-draft tiny]
        [--out DIR] [--device cpu]
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
from hyperion_tpu_torch.models.llama import Llama, init_cache, llama_tiny_config
from hyperion_tpu_torch.utils.timing import time_chained, time_fn

# "mid" ≈ a 1B-shaped model; "7b" the Llama-2-7B geometry at a 1k context
MODEL_SPECS = {
    "tiny": dict(max_len=512),
    "mid": dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
                n_kv_heads=16, ff_dim=5504, max_len=2048, dtype="bfloat16"),
    "7b": dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
               n_kv_heads=32, ff_dim=11008, max_len=1024, dtype="bfloat16"),
}


def _init_model(name: str, device, **overrides):
    """overrides: e.g. vocab_size, so a draft shares the target's vocab."""
    cfg = llama_tiny_config(**{**MODEL_SPECS[name], **overrides})
    model = Llama(cfg, device=device).init_params(
        torch.Generator(device=resolve_device(device)).manual_seed(0))
    return cfg, model


def _n_params(model) -> float:
    return round(sum(t.numel() for t in model.state_dict().values()) / 1e6, 1)


def _prefill_and_chain(cfg, model, ids: torch.Tensor, decode_len: int):
    """The prefill timing and the chained one-token decode: (t_prefill,
    t_chain)."""
    batch, prompt_len = ids.shape
    if prompt_len + decode_len > cfg.max_len:
        raise ValueError(f"{prompt_len + decode_len} tokens > max_len "
                         f"{cfg.max_len}")
    dev = ids.device

    def prefill(i):
        with torch.no_grad():
            return model(i, cache=init_cache(cfg, batch, device=dev),
                         cache_index=0)

    t_prefill = time_fn(prefill, ids, warmup=2, iters=5)
    logits, cache = prefill(ids)
    tok0 = torch.argmax(logits[:, -1], -1)

    def decode_step(cache, tok, idx):
        with torch.no_grad():
            logits, cache = model(tok[:, None], cache=cache, cache_index=idx)
        return cache, torch.argmax(logits[:, 0], -1), idx + 1

    budget = cfg.max_len - prompt_len - 1  # longest legal chain
    if budget < 2:
        raise ValueError(f"prompt_len {prompt_len} leaves a {budget}-step "
                         f"decode budget in max_len {cfg.max_len} — shorten "
                         "the prompt")
    k2 = max(2, min(decode_len, budget))
    k1 = max(1, min(k2 - 1, k2 // 3))
    t = time_chained(decode_step, cache, tok0, prompt_len, k1=k1, k2=k2,
                     n_thread=3, max_k2=budget, graph=dev.type == "cuda")
    return t_prefill, t


def _memory(dev) -> tuple[float, float, str]:
    if dev.type != "cuda":
        return 0.0, 0.0, "unavailable"
    return (torch.cuda.memory_allocated(dev) / 1e6,
            torch.cuda.max_memory_allocated(dev) / 1e6, "allocator")


def _reset(dev) -> None:
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def benchmark_decode(name: str, batch: int = 8, prompt_len: int = 128,
                     decode_len: int = 64, quant: str = "none", device=None,
                     **overrides) -> dict:
    dev = resolve_device(device)
    _reset(dev)
    cfg, model = _init_model(name, dev, **overrides)
    if quant == "int8":
        from hyperion_tpu_torch.precision.quant import quantize_llama

        model, _ = quantize_llama(model, cfg)
        cfg = model.cfg
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (batch, prompt_len)), device=dev)
    t_prefill, t = _prefill_and_chain(cfg, model, ids, decode_len)
    live_mb, peak_mb, source = _memory(dev)
    return {
        "model": name,
        "mode": "chain",  # the chained slope (see the module doc)
        "quant": quant,
        "batch": batch,
        "prompt_len": prompt_len,
        "prefill_ms": round(t_prefill.median_ms, 3),
        "decode_ms_per_token": round(t.per_iter_ms, 4),
        "decode_tokens_per_s": round(t.throughput(batch), 1),
        "dispatch_overhead_ms": round(t.overhead_ms, 2),
        "decode_live_mb": round(live_mb, 2),
        "lifetime_peak_mb": round(peak_mb, 2),
        "mem_source": source,
        "params_m": _n_params(model),
    }


# the draft window of the speculative rows and of the breakeven analysis
SPEC_K = 4


def spec_breakeven_acceptance(draft_ms: float, target_ms: float,
                              k: int = SPEC_K) -> float:
    """The per-token draft/target agreement above which k-token
    speculation beats plain greedy decode. Plain emits a token per
    `target_ms`; a round costs `k * draft_ms + target_ms` and emits
    (1 - p^(k+1)) / (1 - p) tokens at acceptance p. Found by bisection;
    inf when even total acceptance cannot pay for the drafts."""
    cost_ratio = (k * draft_ms + target_ms) / target_ms

    def expected_tokens(p: float) -> float:
        if p >= 1.0:
            return float(k + 1)
        return (1.0 - p ** (k + 1)) / (1.0 - p)

    if expected_tokens(1.0) <= cost_ratio:
        return float("inf")
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if expected_tokens(mid) < cost_ratio:
            lo = mid
        else:
            hi = mid
    return round(hi, 4)


def benchmark_speculative(name: str, prompt_len: int = 128,
                          decode_len: int = 64, k: int = SPEC_K,
                          draft: str | None = None, device=None
                          ) -> tuple[list[dict], dict | None]:
    """Batch-1 whole-generation wall time: `generate` against
    `generate_speculative` with the target as its own draft (every
    proposal accepted: the ceiling) and, with `draft`, a smaller model
    on the target's vocab as a real draft. These rows include the
    prefill and every host dispatch, amortised over decode_len: compare
    gen1 rows only with gen1 rows."""
    from hyperion_tpu_torch.infer.generate import generate
    from hyperion_tpu_torch.infer.speculative import generate_speculative

    dev = resolve_device(device)
    _reset(dev)
    cfg, model = _init_model(name, dev)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, prompt_len)), device=dev)
    variants = [("gen1_plain", lambda i: generate(model, i, decode_len,
                                                  device=dev)),
                ("gen1_spec_ceiling", lambda i: generate_speculative(
                    model, model, i, decode_len, k=k, device=dev))]
    dmodel = None
    if draft:
        dcfg, dmodel = _init_model(draft, dev, vocab_size=cfg.vocab_size)
        variants.append((f"gen1_spec_draft_{draft}",
                         lambda i: generate_speculative(
                             model, dmodel, i, decode_len, k=k, device=dev)))
    rows = []
    for mode, fn in variants:
        t = time_fn(fn, ids, warmup=1, iters=3)
        live_mb, peak_mb, source = _memory(dev)
        rows.append({
            "model": name, "mode": mode, "quant": "none", "batch": 1,
            "prompt_len": prompt_len, "prefill_ms": float("nan"),
            "decode_ms_per_token": round(t.median_ms / decode_len, 4),
            "decode_tokens_per_s": round(decode_len / (t.median_ms / 1e3), 1),
            "dispatch_overhead_ms": float("nan"),
            "decode_live_mb": round(live_mb, 2),
            "lifetime_peak_mb": round(peak_mb, 2), "mem_source": source,
            "params_m": _n_params(model)})
        print(f"[decode_bench] {json.dumps(rows[-1])}")

    analysis = None
    if dmodel is not None:
        # measured batch-1 per-forward times of the models already built
        chain_len = min(24, decode_len)
        _, tt = _prefill_and_chain(cfg, model, ids, chain_len)
        _, td = _prefill_and_chain(dcfg, dmodel, ids, chain_len)
        be = spec_breakeven_acceptance(td.per_iter_ms, tt.per_iter_ms, k=k)
        analysis = {"target": name, "draft": draft, "k": k,
                    "target_fwd_ms": round(tt.per_iter_ms, 4),
                    "draft_fwd_ms": round(td.per_iter_ms, 4),
                    "breakeven_acceptance": (be if be != float("inf")
                                             else "unachievable")}
        print(f"[decode_bench] breakeven {json.dumps(analysis)}")
    return rows, analysis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", nargs="*", default=["tiny", "mid"],
                   choices=sorted(MODEL_SPECS))
    p.add_argument("--quant", nargs="*", default=["none", "int8"],
                   choices=["none", "int8"],
                   help="weight variants per model (int8 = weight-only "
                        "quantized decode, precision/quant.py)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--decode-len", type=int, default=64)
    p.add_argument("--speculative", action="store_true",
                   help="add batch-1 plain vs speculative rows")
    p.add_argument("--spec-draft", default=None, choices=sorted(MODEL_SPECS),
                   help="also measure a real cross-model draft pairing")
    p.add_argument("--no-chain", action="store_true",
                   help="skip the chained per-token rows")
    p.add_argument("--out", default="results/torch/benchmarks/decode")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    rows = []

    def flush() -> None:
        write_csv(out / "decode_benchmarks.csv", rows)

    for name in args.models:
        for quant in ([] if args.no_chain else args.quant):
            r = benchmark_decode(name, args.batch, args.prompt_len,
                                 args.decode_len, quant=quant,
                                 device=args.device)
            rows.append(r)
            flush()
            print(f"[decode_bench] {json.dumps(r)}")
        if args.speculative:
            spec_rows, analysis = benchmark_speculative(
                name, args.prompt_len, args.decode_len, draft=args.spec_draft,
                device=args.device)
            rows.extend(spec_rows)
            flush()
            if analysis is not None:
                out.mkdir(parents=True, exist_ok=True)
                (out / f"spec_breakeven_{name}_{args.spec_draft}.json"
                 ).write_text(json.dumps(analysis, indent=2))
    if rows:
        print(f"[decode_bench] results in {out}/")


if __name__ == "__main__":
    main()
