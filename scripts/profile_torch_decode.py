"""Where a contiguous-cache decode step's time goes on one CUDA card, and
what `torch._int_mm` reaches by operand layout.

    python3 scripts/profile_torch_decode.py

  * `decode_profile`: `bench/decode_bench.py`'s "mid" model (a 1B-shaped
    Llama, bf16, its 2048-slot cache from `init_cache`) at batch 8 after
    a 128-token prefill: 4 eager decode steps under torch.profiler, the
    kernels' device time, the top operators and kernels by self device
    time (`key_averages`), and the share of copies (`aten::copy_`).
  * `decode_chain`: the same step as `decode_bench` times it
    (`utils.timing.time_chained`, 8 and 24 steps), eager between CUDA
    events and replayed as CUDA graphs, and graph-replayed at a
    256-slot cache.
  * `int_mm`: `torch._int_mm` on [8192, 8192] int8 with the second
    operand row-major and column-major, and `bench/hw_explore.py`'s
    int8 row (the requantized carry) at 8192.

Prints one JSON line a section. Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperion_tpu_torch.bench import decode_bench, hw_explore  # noqa: E402
from hyperion_tpu_torch.models.llama import init_cache  # noqa: E402
from hyperion_tpu_torch.utils.timing import time_chained  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model = decode_bench._init_model("mid", "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(1, cfg.vocab_size, (8, 128), generator=g,
                        device="cuda")

    def prefill(slots):
        with torch.no_grad():
            logits, cache = model(ids, cache=init_cache(cfg, 8, slots,
                                                        device="cuda"),
                                  cache_index=0)
        return logits[:, -1].argmax(-1), cache

    def step(cache, tok, idx):
        with torch.no_grad():
            logits, cache = model(tok[:, None], cache=cache, cache_index=idx)
        return cache, logits[:, 0].argmax(-1), idx + 1

    tok, cache = prefill(cfg.max_len)
    for i in range(3):
        step(cache, tok, 128 + i)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(4):
            step(cache, tok, 131 + i)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # operators carry their kernels' device time too: the total counts
    # the kernels alone
    total = sum(device_us(e) for e in events
                if str(e.device_type).endswith("CUDA"))
    top = sorted(events, key=device_us, reverse=True)[:12]
    copies = sum(device_us(e) for e in events if e.key == "aten::copy_")
    emit({"section": "decode_profile", "steps": 4,
          "device_ms": total / 1e3, "copy_share": copies / total,
          "top_ms": {e.key[:60]: device_us(e) / 1e3 for e in top}})

    chain = {}
    for graph in (False, True):
        t = time_chained(step, cache, tok, 128, k1=8, k2=24, n_thread=3,
                         graph=graph, max_k2=512)
        chain["graph" if graph else "eager"] = t.per_iter_ms
    tok256, cache256 = prefill(256)
    t = time_chained(step, cache256, tok256, 128, k1=8, k2=24, n_thread=3,
                     graph=True, max_k2=100)
    chain["graph_cache256"] = t.per_iter_ms
    emit({"section": "decode_chain", "ms_per_step": chain})

    n = 8192
    a = torch.randint(-127, 128, (n, n), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (n, n), generator=g, device="cuda",
                      dtype=torch.int8)
    tops = {}
    for name, operand in (("row_major", b), ("column_major",
                                             b.t().contiguous().t())):
        t = time_chained(torch._int_mm, a, operand, k1=4, k2=12, graph=True)
        tops[name] = 2 * n ** 3 / (t.per_iter_ms / 1e3) / 1e12
    row = hw_explore.matmul_tflops([n], ["int8"])[0]
    emit({"section": "int_mm", "size": n, "tops": tops,
          "hw_explore_int8_tops": row["tflops"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
