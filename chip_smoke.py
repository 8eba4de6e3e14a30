"""Chip smoke for the PyTorch/CUDA port (`hyperion_tpu_torch/`) on one
NVIDIA H100 — the quickest proof that the port builds, is right, trains
and serves on the card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line (a failing phase raises, and the
script exits non-zero):

  1. device   the card's name and power limit (nvidia-smi) and torch's
              name for it.
  2. build    nvcc builds every kernel in hyperion_tpu_torch/ops/csrc/
              for sm_90a (all sources at once).
  3. kernels  each kernel against its plain PyTorch version on CUDA
              tensors: paged attention at Llama-2-7B heads (decode [8,1],
              verify [8,5], prefill [1,512]; serve_features' spec verify
              [4,5] at ragged bases and chunk segments [1,256] at base
              256 and 263) and 70B heads, bf16 and fp32, each with its
              plan (rows a block, splits of the
              chain), registers and spill bytes; at head dims 16, 80 and
              256; decode rows shorter than one split, ending on a split
              boundary and covering the whole table; prefill windows at
              base 0, at base 37 (no multiple of the block size) and of
              8192 query rows at 70B heads;
              the null-block poison check and a rerun, both
              bit-identical; RMSNorm at
              [8*512, 4096] (the Llama step's rows, a block a row), at
              [4096, 1024] (a warp a row), [4096, 1001] and a misaligned
              [4096, 4096] view (scalar loads), each call's kernel named;
              its backward kernel at [4096, 4096] against its closed form
              and autograd's gradient, with and without dw, reruns
              bit-identical; LayerNorm on its warp-a-row kernel at
              [4096, 256] (bf16, fp32, with and without residual) and
              [4096, 768], on its block-a-row kernel at [4096, 1001] and
              a misaligned [4096, 256] view, each call's kernel named,
              and at the train_long step's [32768, 256];
              cross-entropy forward and backward at the train step's
              [32, 127, 50257] fp32 logits view, its rows in bf16, the
              train_long step's [8, 4095, 50257] view and a ragged
              [37, 5003]; on a view the backward as the loss path runs
              it, the gradient of the whole [B, T, V] logits with row
              T-1 exactly zero, and the public backward's contiguous
              output of the view;
              the norms' gradients through the kernels against the plain
              versions' autograd; the flash forward, dq and dk/dv
              kernels at the Llama-2-7B train step ([1, 4096, 32, 128]
              bf16, causal, the last quarter of the keys padding), at
              [2, 1024, 8, 128] fp32
              causal and not and with q scaled by 4 (the split-TF32
              kernels), at a ragged T = 1000, at [2, 200, 8,
              128] bf16 with one batch row all padding, bf16 at
              [1, 4096, 8, 64] and [1, 4096, 8, 32] causal (the D 64
              Hopper kernels; D 32 on them at its own width), at one
              train_long layer ([8, 4096, 4, 64] causal with the
              synthetic split's ragged key padding) and at head dims
              80 and 96 (kernels of their own, each launched, on the
              caller's tensors and bit-identical to the D 128 kernel on
              copies padded to 128), alone and through
              `flash_attention_bwd` (two runs bit-identical, from the
              forward kernel's own o and lse), each with its registers,
              spill and shared-memory bytes (no kernel may spill, and
              bf16 must run the three-warpgroup Hopper kernels); the
              cross-entropy at Llama's
              [1, 4095, 32000] fp32 view. Kernel, plain, bound and library
              times, and the whole flash backward against SDPA's masked
              backward in turns (library, kernel, kernel, library).
              Head dim 256 (`phase_flash_d256`): bf16 [1, 4096, 8, 256]
              with the Llama step's masks, a ragged [2, 1000, 8, 256],
              [2, 200, 8, 256] with a row all padding, fp32 [2, 1024, 8,
              256] causal and full and with q scaled by 4, D 160 and 192
              on the D 256 kernels (each launched, on the caller's
              tensors, bit-identical to the same kernels on host-padded
              copies), and one layer of
              lm_d256's step ([2, 4096, 4, 256], ragged padding).
              The weight-only int8 kernels (`phase_int8_kernels`): the
              fused decode dense (`quantized_dense_decode`: bf16 rows
              quantized inside a thread-block cluster) at the 7B decode
              tick's M 4 for every projection width (4096->4096,
              ->11008, 11008->4096, 4096->32000) and ragged M 1, 3; the
              wgmma product at the 512-row prefill (4096->11008) and
              M 17; the cluster product on quantized rows and the byte
              loads once each: every path bit-identical to its plain
              version and a rerun, the Python and C path rules agreeing,
              its registers, spills, shared memory and cluster, against
              `torch._int_mm` plus the epilogue (M > 16) and bf16
              `F.linear`; `quantize_rows` at the decode and prefill
              activations and a weight (bf16), fp32 and fp16 rows, an
              all-zero row each, bit-identical. The byte-load product
              ([9, 4100->500]) and the scalar quantizer (fp32 [3, 1001],
              bf16 [2, 4100]) are timed too, beside their bounds; they
              are off the int8 run's path, so not in the `kernels` line.
  3b. lm_d256  one forward and backward of a TransformerLM at head_dim
              256 (d 1024, 4 heads, 2 layers, GPT-2 vocab, bf16, batch
              2, seq 4096, ragged padding) with attention_impl "pallas",
              against the same weights at "xla": loss and gradients
              within the bounds `phase_lm_d256` derives, 2 flash
              forward, 2 dq and 2 dk/dv launches; then `flash_attention`
              in fp32 at [2, 1024, 8, 256] through autograd: each fp32
              D 256 kernel launched once, gradients within 2e-4.
  3c. any_head_dim  every kernel at the head dims it took only in part
              before: paged attention at decode [4, 1] and prefill
              [1, 512] (base 256, 32 heads over 8) at D 8, 72, 100, 264,
              320 and 512, bf16 and fp32, with the poison and a rerun at
              each D; flash forward, dq and dk/dv past 256 (the wide
              kernels) at D 264, 320 and 512, ragged causal and full with
              a row all padding, bf16 and fp32; timed at the new phases'
              shapes beside SDPA's masked call and its backend.
     lm_d512  phase_lm_d256's step at head_dim 512 (d 1024 over 2 heads)
              on the wide flash kernels, with its bounds and launches.
     serve_odd_d, serve_wide_d  2-layer fp32 Llamas at head_dim 72 (32
              heads over 8 KV heads, d 2304) and 320 (8 heads, d 2560),
              served at 4 slots with CUDA graphs through the paged kernel
              and the gather read: streams equal (or a near tie), the
              kernel's launches counted, none for the gather run. Each of
              these phases prints its seconds.
  4. train_model  a tiny fp32 TransformerLM on the CPU (plain versions)
              against the same weights on the card (kernels): logits,
              loss and every gradient.
  5. train    `train_language_model` at the language_ddp widths (bf16,
              jit+pallas, batch 32, seq 128, 50 steps, dropout 0.1,
              synthetic validation) with the reference's defaults
              (health "warn", prefetch 2, an async epoch-boundary
              checkpoint): the loss falls, one CSV row, the export
              reloads, launch counters exact, the checkpoint verifies,
              the MFU gauge in (0, 1) against the datasheet peak; step
              time p50 (CUDA events), tokens/s, peak memory, the
              checkpoint's dispatch and commit seconds and bytes, MFU and
              input wait as smoke readings.
  6. train_long  the same trainer at seq 4096, batch 8, 30 steps and 30
              validation batches, where "auto" attention resolves to the
              flash kernels at head_dim 64 (the D 64 Hopper kernels, with
              ragged key padding and the causal mask together): finite
              losses that fall, launch counters exact for flash,
              LayerNorm and cross-entropy; step time p50, tokens/s, peak
              memory as smoke readings.
     train_resume  language_ddp at the same widths on the committed
              real WikiText-2 splits (train on `test`, 90 steps an
              epoch; validate on `validation`, 76 batches; both read by
              the port's numpy Arrow reader), 2 epochs, in four legs: A
              uninterrupted; B preempted by `sigterm@step=120` and
              resumed in-process at (epoch 1, step 30); C the supervised
              `train` verb through `kill@step=150` (one restart, the
              epoch-1 save adopted by its commit marker); D
              `nan_loss@step=100` under health "abort" (exit 4, the
              newest checkpoint quarantined, a fresh restart). B, C and D
              end bit-identical to A, B's CSV loss column too; B's CE and
              LayerNorm launches, over both calls, exactly A's; the
              supervising process maps no CUDA library. Then step p50
              and input wait at prefetch 2 and 0, in turns. After the
              legs the port's `obs doctor` (`diagnose` and the `obs
              doctor` CLI) gives A and both B runs "healthy", C's killed
              life and D's NaN life the verdicts the supervisor logged
              ("diverged" for D, its checkpoint quarantined), and each
              leg's last life "healthy"; `obs diff` of two prefetch runs
              prints its table.
  7. llama_train_model  a tiny fp32 LoRA Llama (GQA, remat "full",
              attention and norm at "pallas", a padding mask) on the CPU
              against the card: the loss and every adapter gradient, and
              the card's launches exact.
  8. llama_train  `train_llama` at Llama-2-7B widths and depth: bf16,
              LoRA r 16 on q/k/v/o, remat "full", jit+pallas, seq 4096,
              batch 1, 8 steps and 2 validation batches: losses finite
              from ln 32000, the base bit-identical, the B factors moved,
              one CSV row, the adapter export reloads, every kernel's
              launches exact (the RMSNorm backward kernel once a step for
              each norm but the first, whose input is the frozen
              embedding's output); the epoch-boundary checkpoint (the
              base, the adapters and their AdamW state) verified and
              restored; step time p50, tokens/s, peak memory, the
              checkpoint's seconds and bytes and MFU as smoke readings.
              The model is freed before the serve phases.
  8a. dist    one rank under `torchrun --standalone --nproc-per-node 1`
              (NCCL) runs every sharded run of 8a-8c in turn
              (`sharded_runs`, `worker_sharded`), first
              `runtime/comm_check.py`'s collectives at world 1
              (all-reduce sum and max, all-gather, reduce-scatter each
              checked, the ring shift the identity at world 1, said so),
              each one's milliseconds; beside it the `--host-only`
              check of the C++ host coordinator between two host
              processes (no card).
  8b. train_fsdp  `cli.main`'s `train --model language_fsdp` job at the
              train phase's config (its job's lr 1e-4 and clip 1.0) in
              that rank (FSDP2's all-gathers and reduce-scatters at
              world 1): LayerNorm and
              cross-entropy launches exact, the per-step losses
              bit-identical to an unsharded run of the same config in
              this process (the largest difference printed), one CSV
              row, a sharded checkpoint that verifies; then
              `sigterm@step=30` and a resume from the sharded
              checkpoint, whose losses and export are bit-identical to
              the uninterrupted run's. Step p50 as a reading.
  8c. llama_fsdp  `train_llama` on Llama-2-7B `fsdp_bf16` (every
              parameter trained, bf16 throughout, AdamW moments in bf16)
              under FSDP2 at world 1: full widths and
              depth, seq 4096, batch 1, remat "full", 4 steps and 1
              validation batch, no checkpoint or export (40 GB of
              state). Flash forward, dq and dk/dv, RMSNorm and its
              backward (every norm's, the first included: the embedding
              trains) and cross-entropy launches exact, every loss
              finite; step p50 and the allocator's peak as readings.
  8cc. the seq, pipe and expert axes, in the same rank (each axis 1):
              train_moe  `cli.main train --moe_experts 4 --moe_top_k 2
              --moe_every 2` at language_ddp's widths (50 steps + 14
              evals): losses fall, aux near 1, the dropped share printed,
              LayerNorm and CE launches exact; one fp32 step of the MoE
              LM card against CPU (`moe_fp32_step`). train_ulysses
              train_long's config at `--attention-impl ulysses`: losses
              and val_loss bit-identical to train_long's (the all-to-alls
              are the identity), flash launches exact. train_ring the
              same in fp32, 4 steps + 4 evals, at ring and at xla: losses
              within RING_RTOL, no flash launch. pipeline_lm
              `PipelinedLM(n_stages=2, n_microbatches=4)` at language_ddp's
              widths: weights and logits bit-identical to a TransformerLM
              from the same init, one train step.
  8d. dry_init  `cli.main train --model llama --llama_size 7b
              --dry-init --mesh 1,4,1,1` in this process: the memory
              plan on an abstract fsdp-4 mesh (no process group, no
              memory); bytes per device of params, grads and AdamW
              state.
  8e. prepare  `python -m hyperion_tpu_torch.data.prepare --cifar`
              (the synthetic source: 5000 + 1000 images) and `--input`
              on 500 seeded lines with a 300-token BPE, both ending in
              their reload-verify; `load_wikitext2` reads the text split
              back from recordio.
  8f. cifar   `cli.main train --model cifar` in this process: ResNet-18
              at its published widths, bf16, batch 64, lr 1e-3, 2 epochs
              over the prepared recordio split: every loss finite, the
              second epoch's below the first's, validation accuracy above
              chance, the CSV schema, the scaling report, no hand kernel
              launched; step p50, images/s, MFU, peak and the
              checkpoint's readings; then one fp32 step (TF32 off) on the
              card and on the CPU from the same weights, their largest
              differences of logits, loss, parameters and statistics,
              and each leaf's gradient held card against CPU in
              float64.
  8g. scaling `cli.main train --model scaling --scaling_devices 1
              --scaling_jobs cifar --epochs 1 --steps-per-epoch 10`
              (the default `--device cuda`: `run_scaling_experiment(
              device_counts=[1], models=["cifar"], simulate_on_cpu=False,
              ...)`): one torchrun run on the card and a `cifar_ddp` row
              at one device, speedup 1.0.
  9. model    a tiny fp32 Llama at the JAX tiny config's widths (head_dim
              16, GQA rep 2) on the CPU (plain versions) against the same
              weights on the card (kernels), through the three paged
              window shapes.
 10. oracle   Llama-2-7B widths at 2 layers, fp32: temperature-0 engine
              streams equal the port's `generate` (a divergence only at a
              near tie, top-2 margin <= 1e-3), for the default engine and
              for a feature engine (spec_k 4 with n-gram drafts, 64-token
              chunks, a 24-block pool the radix must evict from and a host
              tier that holds what it evicts; spills, restores, chunk
              segments and accepted drafts each >= 1); and
              `generate_speculative` with a 1-layer draft equals
              `generate`. Both engines run their captured CUDA graphs.
 11. serve    full Llama-2-7B (32 layers, bf16, seeded random weights,
              the fused RMSNorm) behind `serve_jsonl`: 8 requests, prefix
              hits, a COW copy, launch counters exactly forwards x layers
              (the wrappers' eager launches plus each graph's captured
              launches at every replay). The engine's compile tier: one
              CUDA graph per surface and shape (`compile_stats()`), each
              graph's build seconds, the graphs' pool bytes, no recompile.
              The tick graph replayed once against the model's eager
              forward on a copy of the pools (logits bit-identical, else
              within 2 ulps of the largest logit; greedy tokens and K/V
              equal), and 8 ticks under torch.profiler counting paged
              attention (and its combine kernel) 32 times and RMSNorm 65
              times a tick by kernel name inside the replays.
 12. serve_features  the same model through `serve_jsonl` on the
              deferred decode paths at once (spec_k 4, n-gram drafts,
              256-token chunks, a 96-block pool, a 2 GiB host tier), in
              three waves: the serve phase's 8 requests and two prompts
              of one token repeated, four 600-token prompts that push the
              first wave's chains to the host, then the shared 200-token
              prefix again.
              Every request done, chunk segments, accepted drafts, spills
              and restores each >= 1, launches exact, no recompile; tick
              p50, tokens per tick, acceptance rate, TTFT and TPOT p50,
              peak memory, bytes spilled and restored, and how many greedy
              streams equal the serve phase's, as smoke readings.
 13. load     the same model under the load generator's seeded Poisson
              traffic (`serve/loadgen.py` `run_load`, closed loop with a
              fresh 4-slot engine warmed to 456-token prompts): 48
              requests at 8/s, a 200-token shared prefix, every fourth
              request class batch. Every request done, no reject, exactly
              the serving report's keys, prefix hits, no recompile,
              launches exact; tokens/s, TTFT and e2e p50/p99, the prefix
              hit rate, each class's TTFT p99 and peak memory as smoke
              readings.
 13a. int8    the load phase's model quantized on the card
              (`quantize_llama`: 225 `quantize_rows` launches, three
              weights bit-identical to the plain quantizer's), then
              `generate` at temperature 0, 32 new tokens, on two
              128-token prompts alone and with two more (batch 4): every
              stream and the prefill logits bit-identical to the same
              model on the plain versions, launches exact (225 int8
              products and 65 RMSNorms a forward, 225 row quantizations
              in the prefill alone: a decode step's denses quantize
              their rows inside the product). Readings: int8-vs-bf16
              prefill logits' relative L2, decode tokens/s of both at
              batch 1 and 4 (prefill taken out), weight bytes, the
              allocator's peak, and the 225 denses of a batch-4 decode
              forward on the model's weights, each captured in one CUDA
              graph, this checkout's kernels against the previous ones
              (`scripts/int8_matmul_baseline.cu`, built beside the
              port's kernels) and bf16 `F.linear`, in turns.
 13b. phase1  each Phase-1 tool through its `main(argv)` into a
              temporary directory (`phase_phase1`): hw_explore (4096 and
              8192, fp32/bf16/fp16/int8; bandwidth at 100M and 500M),
              baseline (its four models, batch 32, bf16), attention_bench
              (seq 1024-8192, both impls, modes and geometries),
              compile_bench (every tier and the train step) and
              decode_bench (tiny and mid, float and int8): every row
              finite or "oom", no rate above 105 % of the datasheet peak.
 14. crash    (`crash_start`, then gather and route while its server
              runs, then `crash_finish`) the port's server over a seeded
              random Llama-2-7B-width
              export (2 layers, fp32) with `--journal --supervise
              --chaos crash@tick=2`: the first life dies hard mid-decode,
              the second replays the journal; every token on the one
              stdout stream once and in order, equal to an uninterrupted
              in-process engine over the same export, the journal
              drained, one restart, the heartbeat's attempt 1, a flight
              record, a compile ledger in each life and no recompile;
              the supervisor logs the port doctor's verdict on the dead
              life, and `obs summarize` and `obs doctor` read the serve
              dir (the last life "healthy", attempt 1).
 14b. gather  crash's export at temperature 0 through both paged reads
              (`serve --paged-attn`): "gather" launches no paged kernel,
              its ledger counts its per-tick copy, its streams equal the
              kernel's (or part at a near tie).
 15. route    `python -m hyperion_tpu_torch.cli.main route` over two port
              replicas (own processes and CUDA contexts) serving the crash
              phase's export, with a tokenizer trained here (512 merges):
              8 requests on stdin (a text prompt, a seeded sampled one,
              two sharing a session) while replica 1 crashes at its third
              tick, then a socket router under `--supervise` that dies at
              its fifth dispatch while `ServeClient(resume=True)` streams
              ride across. Every stream done once, indices 0..n-1, equal
              to the in-process engine; a re-dispatch; the crashed
              replica back with its journal drained; no recompile in any
              replica; a replica's `profile` trace holds the paged
              kernel; the router holds no CUDA context. The failover gap,
              re-dispatches, adoptions and recovered orphans as readings.
              The route supervisor logs the port doctor's verdict on the
              dead router life; `obs doctor` reads each leg's base dir
              ("healthy", a row a replica) and `obs trace --fleet` leg
              1's, its attribution components summing to the measured
              total.
 16. introspect  an engine behind a `MetricsExporter`: the exposition
              carries compile counts, tick profiler and memory ledger;
              `class_brownout` on and off is acknowledged and its gauge
              follows; `profile` for 2 s writes a trace holding the paged
              kernel.
 16a. infer   `python -m hyperion_tpu_torch.infer` at temperature 0, 32
              new tokens, on train's language_ddp export
              (`generate_recompute`) and crash's Llama export
              (`generate`), each plain and with `--quant int8`: each
              printed text equal, byte for byte, to an in-process decode
              of the same weights; the float decodes launch no hand
              kernel, the int8 ones the int8 product once a dense a
              forward and the row quantizer once a dense a forward of
              more than 16 rows.
 17. the `kernels` line: one record per kernel and run (`run`: serve,
              serve_features, load, train, train_resume, train_long,
              llama_train, train_fsdp, llama_fsdp, train_moe,
              train_ulysses, train_ring, train_ring_xla, pipeline_lm,
              int8, lm_d256, flash_d256_fp32) at
              that run's shapes, with its launches on the run, its error
              against the plain version and its times.

Kernel times are device times with host dispatch taken out: a run of
launches captured in one CUDA graph and replayed, on copies of the
inputs that together exceed the L2 cache, so each launch finds its
inputs cold (see `time_ms`). Where a train step's device time goes is
`scripts/profile_torch_train.py`'s work, not this script's.

The last line is {"ok": true, "device": {...}}. Without CUDA the
script prints no result and exits 1. The script takes no arguments; a
subset of phases runs by importing the phase functions. The sharded
phases run it again under torchrun as a rank (`chip_smoke.py --worker
sharded OUT ...`, `worker_main`), which writes its readings to OUT.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# fp32: the least time for fp32-accurate products is three TF32 passes
# (hi.hi + hi.lo + lo.hi of operands split as hi + lo) at the dense TF32
# tensor-core rate, 495 TFLOP/s; one pass alone misses the fp32 bounds
PEAK_OPS = {torch.bfloat16: 989e12,  # dense bf16 tensor-core rate
            torch.float32: 495e12 / 3,
            torch.int8: 1978.9e12}    # dense int8 tensor-core rate
L2_BYTES = 50 * 2 ** 20             # H100 L2 cache
SEED = 0
# (atol, rtol) of a kernel against its plain version. bf16: both sides
# compute in fp32 and round once, so they may differ by one bf16 ulp, at
# most 2**-7 of the value.
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-3, 2.0 ** -7)}


def emit(obj) -> None:
    print(json.dumps(obj, separators=(",", ":")), flush=True)


@functools.cache
def side_stream() -> torch.cuda.Stream:
    """One warm-up stream for every timing: cuBLAS keeps a workspace for
    each stream it meets, so a stream per timing would pile them up."""
    return torch.cuda.Stream()


def time_ms(fn, args: tuple, nbytes: float, calls: int = 20,
            reps: int = 5) -> float:
    """Device time of one call `fn(*args)` with host dispatch taken out:
    `calls` launches captured in one CUDA graph, replayed `reps` times
    between CUDA events. The launches rotate over copies of `args` that
    together exceed twice the L2 cache (`nbytes`: what one call reads
    and writes), so each launch finds its inputs cold, as a layer's K/V
    and weights are on the serve path."""
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [args] + [tuple(a.clone() for a in args)
                     for _ in range(copies - 1)]
    return replay_ms(fn, sets, max(calls, copies), reps)


def replay_ms(fn, sets: list[tuple], calls: int = 20, reps: int = 5) -> float:
    """`time_ms` on ready-made argument sets: `calls` launches rotating
    over `sets`, captured on the warm-up stream (so autograd work whose
    forward ran there is captured too), replayed `reps` times."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for a in sets[:3]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def int8_profile():
    """`scripts/profile_torch_int8.py` as a module: the previous int8
    kernels' build (`Baseline`) and the forward's dense sum in turns."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "profile_torch_int8.py"
    mod = sys.modules.get("profile_torch_int8")
    if mod is None:
        spec = importlib.util.spec_from_file_location("profile_torch_int8",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["profile_torch_int8"] = mod
        spec.loader.exec_module(mod)
    return mod


BASELINE = {}  # the previous int8 kernels, started building in phase_build


def phase_build() -> None:
    from hyperion_tpu_torch.ops import build

    t0 = time.perf_counter()
    # the int8 yardstick's nvcc runs beside the port's
    BASELINE["int8"] = int8_profile().Baseline()
    libs = build.build_all()
    for stem in libs:
        build.load(stem)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": build.build_seconds, "libraries": sorted(libs)})


def paged_geometry(B, T, H, Hkv, dtype, *, D=128, bs=16, MB=64, base=None,
                   seed=0, dev="cuda"):
    """Pools + per-row block chains at given depths; unmapped entries 0
    (the null block), as serve/blocks.py hands them to the model."""
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(NB, bs, Hkv, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(NB, bs, Hkv, D, generator=g, device=dev).to(dtype)
    if base is None:
        base = rng.integers(0, MB * bs - T + 1, B)
    base = np.asarray(base, np.int32)
    bt = np.zeros((B, MB), np.int32)
    for b in range(B):
        n = (int(base[b]) + T + bs - 1) // bs
        bt[b, :n] = rng.permutation(np.arange(1, NB))[:n]
    return (q, kp, vp, torch.as_tensor(bt, device=dev),
            torch.as_tensor(base, device=dev))


def paged_cost(q, kp, bt, base) -> tuple[float, float]:
    """(bytes, flops) the function needs for these inputs
    (`paged_attention.cost`: q, the K/V positions the frontier covers and
    the output once each; 4*D flops per visible (query, position) pair)."""
    from hyperion_tpu_torch.ops.paged_attention import cost

    B, T, H, D = q.shape
    return cost(B, T, H, kp.shape[2], D, kp.shape[1], bt.shape[1],
                base.cpu().numpy(), q.element_size())


def check_paged(name, geo, dtype, timing: bool) -> dict:
    """The paged kernel against its plain version on one geometry, with
    its plan (rows a block, splits of the chain) and what the compiler
    gave the split kernel (registers, spill bytes) and the combine."""
    from hyperion_tpu_torch.ops import paged_attention as pa

    q, kp, vp, bt, base = geo
    out = pa.paged_attention(q, kp, vp, bt, base)
    ref = pa.paged_attention_plain(q, kp, vp, bt, base)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    plan = pa.plan_for(q, kp, bt)
    attrs = pa.kernel_attrs(q.shape[-1], dtype, plan)
    rec = {"phase": "kernels", "kernel": "paged_attention", "case": name,
           "dtype": str(dtype).split(".")[-1], "shape": list(q.shape),
           "kv_heads": kp.shape[2], "table": list(bt.shape),
           "block_size": kp.shape[1], "plan": dataclasses.asdict(plan),
           **attrs, "combine_registers": pa.kernel_attrs(
               q.shape[-1], dtype, plan, "combine")["registers"],
           "max_abs_err": float(err.max()),
           "atol": atol, "rtol": rtol, "ok": ok}
    if timing:
        nbytes, ops = paged_cost(q, kp, bt, base)
        rec["kernel_ms"] = time_ms(pa.paged_attention, geo, nbytes)
        rec["plain_ms"] = time_ms(pa.paged_attention_plain, geo, nbytes)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
        rec["library_ms"] = None
    emit(rec)
    if not ok:
        raise AssertionError(f"paged_attention {name} {dtype}: max err "
                             f"{rec['max_abs_err']} over atol {atol} + "
                             f"rtol {rtol}")
    return rec


def check_poison(dtype, D: int = 128) -> None:
    """Huge values in the null block 0 behind every unmapped table entry
    change no bit of the output, and a second run gives the same bits
    (the splits merge in a fixed order, no atomics), at head_dim D."""
    from hyperion_tpu_torch.ops.paged_attention import paged_attention

    q, kp, vp, bt, base = paged_geometry(8, 5, 32, 32, dtype, D=D, seed=7)
    assert int((bt == 0).sum()) > 0, "no unmapped entries to poison"
    clean = paged_attention(q, kp, vp, bt, base)
    rerun = paged_attention(q, kp, vp, bt, base)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = 1e4
    vp2[0] = -1e4
    poisoned = paged_attention(q, kp2, vp2, bt, base)
    torch.cuda.synchronize()
    same = bool(torch.equal(clean, poisoned))
    again = bool(torch.equal(clean, rerun))
    emit({"phase": "kernels", "kernel": "paged_attention", "case": "poison",
          "dtype": str(dtype).split(".")[-1], "head_dim": D,
          "bit_identical": same,
          "rerun_bit_identical": again})
    if not same:
        raise AssertionError("null-block poison leaked into the output")
    if not again:
        raise AssertionError("two runs of paged_attention differ")


def paged_edge_cases(dtype) -> None:
    """The redesign's edges, each against the plain version: head dims
    16, 80 and 256 (decode, verify, prefill); decode rows whose visible
    length is shorter than one split, ends exactly on a split boundary,
    and covers the whole table; prefill windows at base 0, at a base no
    multiple of the block size, and of 8192 rows at 70B heads."""
    from hyperion_tpu_torch.ops.paged_attention import plan

    for D in (16, 80, 256):
        check_paged(f"decode_d{D}", paged_geometry(8, 1, 32, 32, dtype, D=D,
                                                   seed=30 + D), dtype,
                    timing=False)
        check_paged(f"verify_d{D}_70b_heads", paged_geometry(
            4, 5, 64, 8, dtype, D=D, seed=31 + D), dtype, timing=False)
        check_paged(f"prefill_d{D}", paged_geometry(
            1, 300, 8, 4, dtype, D=D, base=[100], seed=32 + D), dtype,
            timing=False)
    split = plan(3, 1, 32, 32, 128, 16, 64).split_len
    check_paged("split_edges", paged_geometry(
        3, 1, 32, 32, dtype, base=[split // 2, 2 * split - 1, 64 * 16 - 1],
        seed=33), dtype, timing=False)
    check_paged("prefill_base0", paged_geometry(
        1, 512, 32, 32, dtype, base=[0], seed=34), dtype, timing=False)
    check_paged("prefill_base37_70b_heads", paged_geometry(
        1, 200, 64, 8, dtype, base=[37], seed=35), dtype, timing=False)
    # 70B heads at 8192 query rows (1024 tokens x rep 8) over a chain
    # of 4096 positions: 128 row tiles, each chain in two splits
    check_paged("prefill_70b_8192_rows", paged_geometry(
        1, 1024, 64, 8, dtype, MB=256, base=[3000], seed=36), dtype,
        timing=False)


def rms_ulp_ok(out, ref) -> tuple[bool, float]:
    if out.dtype == torch.bfloat16:
        a = out.view(torch.int16).int()
        b = ref.view(torch.int16).int()
        ulps = (a - b).abs()
        return bool((ulps <= 1).all()), float(ulps.max())
    err = (out - ref).abs()
    return bool((err <= 2e-5 + 2e-5 * ref.abs()).all()), float(err.max())


def check_rms(name, x, w, path, timing: bool) -> dict:
    """The RMSNorm forward kernel against its plain version, and that the
    call took the kernel `path` ("warp", "block" or "scalar") names."""
    from hyperion_tpu_torch.ops.fused_norm import (
        fused_rmsnorm,
        fused_rmsnorm_plain,
        rmsnorm_path,
    )

    out = fused_rmsnorm(x, w, eps=1e-5)
    ref = fused_rmsnorm_plain(x, w, eps=1e-5)
    torch.cuda.synchronize()
    ok, worst = rms_ulp_ok(out, ref)
    took = rmsnorm_path(x, w)
    rec = {"phase": "kernels", "kernel": "fused_rmsnorm", "case": name,
           "dtype": str(x.dtype).split(".")[-1], "shape": list(x.shape),
           "path": took,
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "worst": worst,
           "tol": "1 ulp" if x.dtype == torch.bfloat16 else 2e-5,
           "ok": ok and took == path}
    if timing:
        d = x.shape[-1]
        rows = x.numel() // d
        nbytes = 2 * x.numel() * x.element_size() + 4 * d
        rec["kernel_ms"] = time_ms(fused_rmsnorm, (x, w), nbytes)
        rec["plain_ms"] = time_ms(fused_rmsnorm_plain, (x, w), nbytes)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4.0 * rows * d,
                                                 x.dtype)
        rec["library_ms"] = time_ms(
            lambda xs, ws: torch.nn.functional.rms_norm(xs, (d,), ws, 1e-5),
            (x, w.to(x.dtype)), nbytes)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"fused_rmsnorm {name} {x.dtype}: {worst} "
                             f"over tolerance, or the {took} kernel where "
                             f"the {path} kernel was due")
    return rec


def rms_dw_ok(dw, ref, rows: int) -> tuple[bool, float]:
    """dw (fp32, a sum over `rows` rows taken in another order) within
    4 sqrt(rows) 2**-24 max|dw|."""
    err = float((dw - ref).abs().max())
    return err <= 4 * rows ** 0.5 * 2.0 ** -24 * float(ref.abs().max()), err


def bwd_replay_ms(forward, sets: list[tuple]) -> float:
    """Device time of one whole autograd backward of `forward(x, w)`
    against cotangent g, the forward left out of the timed window: one
    forward a set of (x, w, g) (x a leaf that needs a gradient; the
    gradient of w is taken too where w needs one), then `replay_ms` of
    `torch.autograd.grad` over them. The forwards run on the warm-up
    stream, where the capture puts their backward."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    graphs = []
    with torch.cuda.stream(side):
        for x, w, g in sets:
            leaf = x.detach().requires_grad_()
            wrt = (leaf, w) if w.requires_grad else (leaf,)
            graphs.append((forward(leaf, w), wrt, g))
    torch.cuda.current_stream().wait_stream(side)
    return replay_ms(lambda y, wrt, g: torch.autograd.grad(
        y, wrt, g, retain_graph=True), graphs)


def check_rms_bwd(name, x, w, g, timing: bool) -> tuple[dict, dict | None]:
    """The RMSNorm backward kernel against its closed form
    (`fused_rmsnorm_bwd_plain`) and against autograd of the plain
    forward, dx alone (the Llama LoRA step: the norm weights are frozen)
    and with dw (the full fine-tune: the dw variant of the backward
    kernel and `rmsnorm_dw_kernel`): dx as `ln_ulp_ok`, dw as
    `rms_dw_ok`, two runs bit-identical. Timed, each variant: the
    kernel, its closed form, and `F.rms_norm`'s own backward (the
    forward outside the window). Returns the dx-alone record and, when
    timed, the record of the variant with dw (`<name>_with_dw`)."""
    from hyperion_tpu_torch.ops.fused_norm import (
        fused_rmsnorm_bwd,
        fused_rmsnorm_bwd_plain,
        fused_rmsnorm_plain,
        rmsnorm_bwd_path,
    )

    d = x.shape[-1]
    rows = x.numel() // d
    # dx alone and dx with dw take other block layouts, so their dx may
    # differ in the last bit; each reruns bit-identically
    dx, none = fused_rmsnorm_bwd(x, w, g, need_dw=False)
    dx_w, dw = fused_rmsnorm_bwd(x, w, g)
    again = (fused_rmsnorm_bwd(x, w, g, need_dw=False)[0],
             *fused_rmsnorm_bwd(x, w, g))
    ref_dx, ref_dw = fused_rmsnorm_bwd_plain(x, w, g)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    fused_rmsnorm_plain(xs, ws).backward(g)
    torch.cuda.synchronize()
    checks = {"dx": ln_ulp_ok(dx, ref_dx),
              "dx_with_dw": ln_ulp_ok(dx_w, ref_dx),
              "dw": rms_dw_ok(dw, ref_dw, rows),
              "dx_autograd": ln_ulp_ok(dx, xs.grad),
              "dw_autograd": rms_dw_ok(dw, ws.grad, rows)}
    rerun = (none is None and all(
        torch.equal(a, b) for a, b in zip((dx, dx_w, dw), again)))
    rec = {"phase": "kernels", "kernel": "fused_rmsnorm_bwd", "case": name,
           "dtype": str(x.dtype).split(".")[-1], "shape": list(x.shape),
           "path": rmsnorm_bwd_path(x, w, g),
           "max_abs_err": float((dx.float() - ref_dx.float()).abs().max()),
           "dw_max_abs_err": checks["dw"][1],
           "worst": {k: v for k, (_, v) in checks.items()},
           "tol": {"dx": "1 ulp, at least 2^-16" if x.dtype == torch.bfloat16
                   else 2e-5, "dw": "4 sqrt(rows) 2^-24 max|dw|"},
           "rerun_bit_identical": rerun,
           "ok": rerun and all(ok for ok, _ in checks.values())}
    del xs, ws, again
    if timing:
        # dx alone: x and g read, dx written, the weight read
        nbytes = 3 * x.numel() * x.element_size() + 4 * d
        rec["kernel_ms"] = time_ms(
            lambda xs, ws, gs: fused_rmsnorm_bwd(xs, ws, gs, need_dw=False),
            (x, w, g), nbytes)
        rec["plain_ms"] = time_ms(fused_rmsnorm_bwd_plain, (x, w, g), nbytes)
        # ~10 flops an element: two sums, w g, the two products of dx
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 10.0 * rows * d,
                                                 x.dtype)
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(x, w.to(x.dtype), g)] + [
            (x.clone(), w.to(x.dtype), g.clone()) for _ in range(copies - 1)]
        rec["library_ms"] = bwd_replay_ms(
            lambda xs, ws: torch.nn.functional.rms_norm(xs, (d,), ws, 1e-5),
            sets)
        # with dw: the fp32 dw written too; ~3 more flops an element
        # (x r g and its sum over the rows)
        dw_bytes = nbytes + 4 * d
        dw_rec = {**rec, "case": f"{name}_with_dw",
                  "max_abs_err": max(
                      float((dx_w.float() - ref_dx.float()).abs().max()),
                      float((dw.float() - ref_dw.float()).abs().max())),
                  "kernel_ms": time_ms(fused_rmsnorm_bwd, (x, w, g),
                                       dw_bytes),
                  "plain_ms": time_ms(fused_rmsnorm_bwd_plain, (x, w, g),
                                      dw_bytes),
                  "library_ms": bwd_replay_ms(
                      lambda xs, ws: torch.nn.functional.rms_norm(
                          xs, (d,), ws, 1e-5),
                      [(a, b.detach().clone().requires_grad_(), c)
                       for a, b, c in sets])}
        dw_rec["bound_ms"], dw_rec["bound_by"] = bound(
            dw_bytes, 13.0 * rows * d, x.dtype)
        del sets
    del dx_w
    emit(rec)
    if timing:
        emit(dw_rec)
    if not rec["ok"]:
        raise AssertionError(f"fused_rmsnorm_bwd {name} {x.dtype}: "
                             f"{rec['worst']}, rerun identical {rerun}")
    return rec, (dw_rec if timing else None)


def ln_ulp_ok(out, ref) -> tuple[bool, float]:
    """`rms_ulp_ok`, with the bf16 ulp taken at no less than 2**-8: where
    `... * w + b` cancels towards zero (LayerNorm), or r w g and
    x r^3 S / d do (the RMSNorm backward's dx), the two sides' fp32
    statistics (summed in other orders) differ by more than the tiny
    output's own ulp, so the error is held to 2**-16 absolute there."""
    if out.dtype != torch.bfloat16:
        return rms_ulp_ok(out, ref)
    ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    near_zero = (out.float() - ref.float()).abs() <= 2.0 ** -16
    return bool(((ulps <= 1) | near_zero).all()), float(ulps.max())


def check_ln(name, x, w, b, residual, path, timing: bool) -> dict:
    """The LayerNorm kernel against its plain version, and that the call
    took the kernel `path` ("warp" or "block") names. Timed with its
    residual where it has one; no single PyTorch call adds a residual
    before the norm, so that case has no library time."""
    from hyperion_tpu_torch.ops.fused_norm import (
        fused_layernorm,
        fused_layernorm_plain,
        layernorm_path,
    )

    out = fused_layernorm(x, w, b, residual=residual, eps=1e-6)
    ref = fused_layernorm_plain(x, w, b, residual=residual, eps=1e-6)
    torch.cuda.synchronize()
    ok, worst = ln_ulp_ok(out, ref)
    took = layernorm_path(x, w, b, residual=residual)
    rec = {"phase": "kernels", "kernel": "fused_layernorm", "case": name,
           "dtype": str(x.dtype).split(".")[-1], "shape": list(x.shape),
           "residual": residual is not None, "path": took,
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "worst": worst,
           "tol": "1 ulp, at least 2^-16" if x.dtype == torch.bfloat16
           else 2e-5, "ok": ok and took == path}
    if timing:
        d = x.shape[-1]
        rows = x.numel() // d
        ins = (x, w, b) if residual is None else (x, w, b, residual)
        nbytes = (len(ins) - 1) * x.numel() * x.element_size() + 2 * 4 * d
        rec["kernel_ms"] = time_ms(
            lambda xs, ws, bs, *rs: fused_layernorm(
                xs, ws, bs, residual=rs[0] if rs else None, eps=1e-6),
            ins, nbytes)
        rec["plain_ms"] = time_ms(
            lambda xs, ws, bs, *rs: fused_layernorm_plain(
                xs, ws, bs, residual=rs[0] if rs else None, eps=1e-6),
            ins, nbytes)
        # ~9 flops an element: add, subtract, square-add, scale, shift
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 9.0 * rows * d,
                                                 x.dtype)
        rec["library_ms"] = None if residual is not None else time_ms(
            lambda xs, ws, bs: torch.nn.functional.layer_norm(
                xs, (d,), ws, bs, 1e-6),
            (x, w.to(x.dtype), b.to(x.dtype)), nbytes)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"fused_layernorm {name} {x.dtype}: {worst} "
                             f"over tolerance, or the {took} kernel where "
                             f"the {path} kernel was due")
    return rec


def ce_case(B, T, V, dtype, seed, strided):
    """(source, take, targets): logits are take(source) — the [B, T-1, V]
    view of [B, T, V] logits, as next_token_loss hands them over, or a
    contiguous [B*T, V] array — and targets match their rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        src = (3 * torch.randn(B, T + 1, V, generator=g, device="cuda")
               ).to(dtype)
        tgt = torch.randint(0, V, (B, T), generator=g, device="cuda",
                            dtype=torch.int32)

        def take(a):
            return a[:, :-1]
    else:
        src = (3 * torch.randn(B * T, V, generator=g, device="cuda")
               ).to(dtype)
        tgt = torch.randint(0, V, (B * T,), generator=g, device="cuda",
                            dtype=torch.int32)

        def take(a):
            return a
    return src, take, tgt


def ce_bwd_fp32_ok(d, ref) -> tuple[bool, float]:
    """fp32 dlogits within 1e-6 of each element's own size: at g ~ 1/rows
    most elements are ~1e-9, so an absolute 1e-6 would pass zeros. The
    floor is the smallest normal fp32, so only subnormals may differ.
    Returns (ok, the worst relative error)."""
    err = (d - ref).abs()
    tiny = torch.finfo(torch.float32).tiny
    return (bool((err <= 1e-6 * ref.abs() + tiny).all()),
            float((err / (ref.abs() + tiny)).max()))


def ce_bwd_full_plain(full, tgt, lse, g):
    """The plain version of the loss path's backward: the gradient of the
    whole [B, T, V] logits of a loss over their view [:, :-1], row T-1
    zero."""
    from hyperion_tpu_torch.ops import fused_ce as ce

    out = torch.zeros_like(full)
    out[:, :-1] = ce.fused_softmax_xent_bwd_plain(full[:, :-1], tgt, lse, g)
    return out


def check_ce(name, src, take, tgt, timing: bool) -> tuple[dict, dict]:
    """The forward and backward kernels against their plain versions:
    loss and lse within 1e-5 relative; dlogits within 1e-6 relative
    (fp32) or one bf16 ulp. Where the logits are the [B, T-1, V] view of
    [B, T, V] ones, the backward is checked and timed as the loss path
    runs it (`_run_bwd_shifted`): the gradient of the whole [B, T, V]
    tensor, row T-1 exactly zero; the public backward's contiguous
    [B, T-1, V] output of the same view (at an odd vocab its rows sit
    off the view's 16-byte grid) is checked too."""
    from hyperion_tpu_torch.ops import fused_ce as ce

    logits = take(src)
    shifted = logits is not src
    dtype = logits.dtype
    V = logits.shape[-1]
    rows = logits.numel() // V
    loss, lse = ce.fused_softmax_xent_fwd(logits, tgt)
    ref_loss, ref_lse = ce._plain_fwd(logits, tgt)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    g = torch.rand(loss.shape, generator=gen, device="cuda") / rows
    t32 = ce._checked_targets(logits, tgt)
    ref_d = ce.fused_softmax_xent_bwd_plain(logits, tgt, lse, g)

    def held(d):
        return rms_ulp_ok(d, ref_d) if dtype == torch.bfloat16 \
            else ce_bwd_fp32_ok(d, ref_d)

    d = ce.fused_softmax_xent_bwd(logits, tgt, lse, g)
    extra = {}
    if shifted:
        extra["view_output_ok"], extra["view_output_worst"] = held(d)
        del d
        full = ce._run_bwd_shifted(src, t32, lse, g)
        extra["last_row_zero"] = not bool(full[:, -1].any())
        d = full[:, :-1]
    torch.cuda.synchronize()
    fwd_err = max(float((loss - ref_loss).abs().max()),
                  float((lse - ref_lse).abs().max()))
    fwd_ok = bool(torch.allclose(loss, ref_loss, rtol=1e-5, atol=1e-6)
                  and torch.allclose(lse, ref_lse, rtol=1e-5, atol=0))
    bwd_ok, bwd_worst = held(d)
    bwd_ok = bwd_ok and all(v for k, v in extra.items()
                            if not k.endswith("worst"))
    bwd_err = float((d.float() - ref_d.float()).abs().max())
    del d, ref_d  # logits-sized: free before the timings' copies
    if shifted:
        del full
    base = {"phase": "kernels", "case": name, "dtype": str(dtype)
            .split(".")[-1], "shape": list(logits.shape),
            "strided": not logits.is_contiguous()}
    fwd = {**base, "kernel": "fused_softmax_xent_fwd", "max_abs_err": fwd_err,
           "tol": "1e-5 rel", "ok": fwd_ok}
    bwd = {**base, "kernel": "fused_softmax_xent_bwd",
           "grad_shape": list((src if shifted else logits).shape),
           "max_abs_err": bwd_err, "worst": bwd_worst,
           "tol": "1 ulp" if dtype == torch.bfloat16 else "1e-6 rel",
           **extra, "ok": bwd_ok}
    if timing:
        it = logits.element_size()
        # forward: the logits once, int32 targets, loss and lse out
        nf = rows * V * it + 3 * 4 * rows
        fwd["kernel_ms"] = time_ms(lambda a, t: ce._run_fwd(take(a), t),
                                   (src, t32), nf)
        fwd["plain_ms"] = time_ms(lambda a, t: ce._plain_fwd(take(a), t),
                                  (src, tgt), nf)
        fwd["bound_ms"], fwd["bound_by"] = bound(nf, 4.0 * rows * V, dtype)
        flat = logits.reshape(rows, V)  # F.cross_entropy's [N, C] layout
        tl = tgt.reshape(rows).long()
        fwd["library_ms"] = time_ms(
            lambda a, t: torch.nn.functional.cross_entropy(
                a, t, reduction="none"), (flat, tl), nf)
        # backward: the logits in, the gradient out (the whole [B, T, V]
        # where shifted), targets, lse and g
        nb = (rows * V + (src if shifted else logits).numel()) * it \
            + 3 * 4 * rows
        if shifted:
            bwd["kernel_ms"] = time_ms(ce._run_bwd_shifted,
                                       (src, t32, lse, g), nb)
            bwd["plain_ms"] = time_ms(ce_bwd_full_plain,
                                      (src, tgt, lse, g), nb)
        else:
            bwd["kernel_ms"] = time_ms(ce._run_bwd, (src, t32, lse, g), nb)
            bwd["plain_ms"] = time_ms(ce.fused_softmax_xent_bwd_plain,
                                      (src, tgt, lse, g), nb)
        bwd["bound_ms"], bwd["bound_by"] = bound(nb, 4.0 * rows * V, dtype)
        side_stream().wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side_stream()):  # the graph's stream
            leaf = flat.detach().clone().requires_grad_()
            lib_loss = torch.nn.functional.cross_entropy(
                leaf, tl, reduction="none")
        bwd["library_ms"] = replay_ms(
            lambda lo, x, gg: torch.autograd.grad(lo, x, gg,
                                                  retain_graph=True),
            [(lib_loss, leaf, g.reshape(rows))])
        del leaf, lib_loss
    emit(fwd)
    emit(bwd)
    if not (fwd_ok and bwd_ok):
        raise AssertionError(f"fused_softmax_xent {name} {dtype}: forward "
                             f"err {fwd_err}, backward worst {bwd_worst}, "
                             f"{extra}")
    return fwd, bwd


def check_norm_grads() -> None:
    """Gradients through the norm kernels equal autograd of the plain
    versions: LayerNorm's (autograd of the plain version on the saved
    inputs) within the forward tolerances, RMSNorm's (the backward
    kernel) dx as `ln_ulp_ok` and dw as `rms_dw_ok`."""
    from hyperion_tpu_torch.ops.fused_norm import (
        fused_layernorm,
        fused_layernorm_plain,
        fused_rmsnorm,
        fused_rmsnorm_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        x, r, gy = (torch.randn(4096, 256, generator=g, device="cuda")
                    .to(dtype) for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(256, generator=g, device="cuda")
        b = 0.1 * torch.randn(256, generator=g, device="cuda")
        cases.append(("fused_layernorm", dtype, (x, r, w, b), gy,
                      lambda x, r, w, b: fused_layernorm(
                          x, w, b, residual=r, eps=1e-6),
                      lambda x, r, w, b: fused_layernorm_plain(
                          x, w, b, residual=r, eps=1e-6)))
        x, gy = (torch.randn(512, 4096, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        w = 1.0 + 0.1 * torch.randn(4096, generator=g, device="cuda")
        cases.append(("fused_rmsnorm", dtype, (x, w), gy, fused_rmsnorm,
                      fused_rmsnorm_plain))
    for kernel, dtype, ins, gy, fn, plain in cases:
        grads = []
        for f in (fn, plain):
            leaves = [t.clone().requires_grad_() for t in ins]
            f(*leaves).backward(gy)
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        if kernel == "fused_rmsnorm":
            (dx, dw), (ref_dx, ref_dw) = grads
            worst = [ln_ulp_ok(dx, ref_dx),
                     rms_dw_ok(dw, ref_dw, ins[0].shape[0])]
        else:
            worst = [rms_ulp_ok(a, c) for a, c in zip(*grads)]
        ok = all(o for o, _ in worst)
        emit({"phase": "kernels", "kernel": kernel, "case": "gradients",
              "dtype": str(dtype).split(".")[-1],
              "worst": max(v for _, v in worst), "ok": ok})
        if not ok:
            raise AssertionError(f"{kernel} {dtype}: gradients through the "
                                 f"kernel differ from the plain version's")


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the records of
    the training paths' shapes for the `kernels` line, by run ("train",
    "train_long", "llama_train", "llama_fsdp")."""
    recs = {"train": {}, "train_long": {}, "llama_train": {},
            "serve_features": []}
    for dtype in (torch.bfloat16, torch.float32):
        for H, Hkv, tag in ((32, 32, "7b"), (64, 8, "70b")):
            check_paged(f"decode_{tag}", paged_geometry(8, 1, H, Hkv, dtype),
                        dtype, timing=True)
            check_paged(f"verify_{tag}", paged_geometry(8, 5, H, Hkv, dtype,
                                                        seed=1),
                        dtype, timing=False)
            check_paged(f"prefill_{tag}",
                        paged_geometry(1, 512, H, Hkv, dtype, base=[256],
                                       seed=2), dtype, timing=True)
        # the serve_features run's windows at 7B heads: the spec tick's
        # verify window [4, 5] at ragged bases, and a chunk segment
        # [1, 256] at base 256 and at a base no multiple of 16
        for name, geo in (
                ("spec_verify_4x5", paged_geometry(
                    4, 5, 32, 32, dtype, base=[37, 300, 611, 950],
                    seed=40)),
                ("chunk_1x256_base256", paged_geometry(
                    1, 256, 32, 32, dtype, base=[256], seed=41)),
                ("chunk_1x256_base263", paged_geometry(
                    1, 256, 32, 32, dtype, base=[263], seed=42))):
            rec = check_paged(name, geo, dtype, timing=True)
            if dtype == torch.bfloat16 and name != "chunk_1x256_base263":
                recs["serve_features"].append(("paged_attention", rec))
        check_poison(dtype)
        paged_edge_cases(dtype)
        # RMSNorm at the Llama step's [4096, 4096] (a block a row), its
        # backward there, one width per other kernel and a view one
        # element into its buffer (off the 16-byte grid: checked only)
        g = torch.Generator(device="cuda").manual_seed(3)
        x, gy = (torch.randn(8 * 512, 4096, generator=g, device="cuda")
                 .to(dtype) for _ in range(2))
        w = 1.0 + 0.1 * torch.randn(4096, generator=g, device="cuda")
        rec = check_rms("prefill_8x512", x, w, "block", timing=True)
        bwd, bwd_dw = check_rms_bwd("llama_step_4096x4096", x, w, gy,
                                    timing=True)
        if dtype == torch.bfloat16:
            recs["llama_train"] = {"fused_rmsnorm": rec,
                                   "fused_rmsnorm_bwd": bwd}
            # the full fine-tune computes every norm's dw
            recs["llama_fsdp"] = {"fused_rmsnorm": rec,
                                  "fused_rmsnorm_bwd": bwd_dw}
        flat = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
        view = flat[1:].view_as(x)
        view.copy_(x)
        check_rms("misaligned_4096x4096", view, w, "scalar", timing=False)
        del x, gy, flat, view
        for d, path in ((1024, "warp"), (1001, "scalar")):
            x = torch.randn(4096, d, generator=g, device="cuda").to(dtype)
            w = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
            check_rms(f"4096x{d}", x, w, path, timing=True)

    # LayerNorm at the language_ddp train step's [B*T, d] = [4096, 256]
    # and at the GPT-2-shaped width 768 (the warp-a-row kernel), at a
    # width of no whole 16-byte chunk and on a misaligned view (the
    # block-a-row kernel)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for d, dtypes, path in ((256, (torch.bfloat16, torch.float32), "warp"),
                            (768, (torch.bfloat16,), "warp"),
                            (1001, (torch.bfloat16,), "block")):
        w = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
        b = 0.1 * torch.randn(d, generator=g, device="cuda")
        for dtype in dtypes:
            x, r = ((torch.randn(4096, d, generator=g, device="cuda") + 0.5)
                    .to(dtype) for _ in range(2))
            rec = check_ln(f"train_4096x{d}", x, w, b, None, path,
                           timing=True)
            if d == 256 and dtype == torch.bfloat16:
                recs["train"]["fused_layernorm"] = rec
            if d == 256:
                check_ln(f"train_4096x{d}_residual", x, w, b, r, path,
                         timing=True)
                # a view one element into its buffer, off the 16-byte
                # grid: timing would copy it aligned, so it is checked only
                flat = torch.empty(4096 * d + 1, device="cuda", dtype=dtype)
                view = flat[1:].view(4096, d)
                view.copy_(x)
                check_ln(f"misaligned_4096x{d}", view, w, b, None, "block",
                         timing=False)
    # LayerNorm at the train_long step's [B*T, d] = [32768, 256]
    w = 1.0 + 0.1 * torch.randn(256, generator=g, device="cuda")
    b = 0.1 * torch.randn(256, generator=g, device="cuda")
    x = (torch.randn(8 * 4096, 256, generator=g, device="cuda") + 0.5).to(
        torch.bfloat16)
    recs["train_long"]["fused_layernorm"] = check_ln(
        "train_long_32768x256", x, w, b, None, "warp", timing=True)
    # and in fp32, the train_ring run's (and its xla baseline's)
    recs["train_ring"] = {"fused_layernorm": check_ln(
        "train_ring_32768x256_fp32", x.float(), w, b, None, "warp",
        timing=True)}
    del x
    # cross-entropy at the train step's [32, 127, 50257] fp32 logits view
    # (4064 rows), at the train_long step's [8, 4095, 50257] one (32,760
    # rows, 6.6 GB of logits), the train step's rows contiguous in bf16,
    # and a small ragged vocab
    for run, (B, T), seed in (("train", (32, 127), SEED + 12),
                              ("train_long", (8, 4095), SEED + 15)):
        recs[run]["fused_softmax_xent_fwd"], \
            recs[run]["fused_softmax_xent_bwd"] = check_ce(
                f"{run}_step_view_{B}x{T}", *ce_case(
                    B, T, 50257, torch.float32, seed, strided=True),
                timing=True)
        gc.collect()
        torch.cuda.empty_cache()
    check_ce("rows_4064_bf16", *ce_case(32, 127, 50257, torch.bfloat16,
                                        SEED + 13, strided=False),
             timing=True)
    check_ce("ragged_37x5003", *ce_case(1, 37, 5003, torch.float32,
                                        SEED + 14, strided=False),
             timing=False)
    gc.collect()
    torch.cuda.empty_cache()
    check_norm_grads()
    return recs


# what the compiler gave a kernel, on the flash kernels' records
ATTR_KEYS = ("registers", "spill_bytes", "smem_bytes", "threads")


def fp32_flash_growth(D: int) -> float:
    """How much wider the fp32 flash bounds are at head_dim D than at the
    reference's D <= 128: an fp32 dot product of D terms is off by at
    most ~D·u·Σ|q_d k_d| (u = 2^-24; the split-TF32 terms alike), Σ|q_d
    k_d| grows as D and the logits are scaled by 1/√D, so the logits'
    bound, and o's, lse's and the gradients' to first order in it,
    grow as D^1.5: 2^1.5 = 2.83 from 128 to 256."""
    return max(1.0, (D / 128) ** 1.5)


def flash_close(out, ref, dtype, what, D: int = 128) -> tuple[bool, float]:
    """(ok, max abs error) of a flash kernel output against its plain
    version at head_dim D. fp32: 2e-5 for o and lse, 2e-4 for gradients
    (the reference's own kernel bounds), times `fp32_flash_growth(D)`
    past D 128. bf16 o: the kernel rounds p to bf16
    per key tile against the running max, the plain version once against
    the row's max — one ulp of p (2^-8) over |v| <= 4, plus one of the
    output: 2^-6 + 2^-7 of the value. lse is fp32 on both sides. bf16
    gradients: the same rounded ds and p summed in another order, then
    rounded: 2^-6 of the largest gradient."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if dtype == torch.float32 or what == "lse":
        tol = 2e-5 if what in ("o", "lse") else 2e-4
        if dtype == torch.float32:
            tol *= fp32_flash_growth(D)
        ok = bool((err <= tol + tol * ref.abs()).all())
    elif what == "o":
        ok = bool((err <= 2.0 ** -6 + 2.0 ** -7 * ref.abs()).all())
    else:
        ok = bool(err.max() <= 2.0 ** -6 * ref.abs().max())
    return ok, float(err.max())


def flash_case(B, T, H, D, dtype, pad_tail, seed, q_scale=1.0):
    """q, k, v, dO [B, T, H, D] and a [B, T] key mask whose last
    `pad_tail` of positions is padding — one fraction for every batch row
    or one per row (1.0: every key of the row) — None for no mask. q is
    scaled by `q_scale` (large logits) before the cast to `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device="cuda")
                   for _ in range(4))
    q, k, v, do = ((q * q_scale).to(dtype), k.to(dtype), v.to(dtype),
                   do.to(dtype))
    pad = None
    if pad_tail:
        tails = pad_tail if isinstance(pad_tail, tuple) else (pad_tail,) * B
        pad = torch.ones(B, T, dtype=torch.int8, device="cuda")
        for row, tail in enumerate(tails):
            pad[row, T - int(T * tail):] = 0
    return q, k, v, do, pad


def ragged_pad(B, T, seed) -> torch.Tensor:
    """A [B, T] int8 key mask of true lengths drawn as the synthetic
    language-model split draws them (`data/text.py`): uniform in
    [T / 4, T]."""
    lengths = np.random.default_rng(seed).integers(T // 4, T + 1, size=B)
    return torch.as_tensor(np.arange(T)[None] < lengths[:, None],
                           dtype=torch.int8, device="cuda")


def flash_pairs(B, T, causal, pad) -> float:
    """(query, key) pairs the masks keep, over the batch: the work each
    of the kernels' products does on these inputs."""
    pos = torch.arange(T)
    keep = (pos[None, :] <= pos[:, None]) if causal \
        else torch.ones(T, T, dtype=torch.bool)
    if pad is None:
        return float(B * keep.sum())
    return float((keep[None] & pad.bool().cpu()[:, None, :]).sum())


def check_flash(name, q, k, v, do, pad, causal, timing: bool) -> dict:
    """The forward, dq and dk/dv kernels against the plain versions (the
    backward from the kernel's own o and lse), standalone and through
    `flash_attention_bwd` (one delta for both kernels, which the dq
    kernel computes); two runs of the forward, and two of the whole
    backward, must be bit-identical;
    each kernel's registers, spill and shared-memory bytes: no kernel
    spills, and bf16 runs the Hopper kernels (three warpgroups). With
    `timing`, kernel, plain, bound and library times, and the whole
    backward against SDPA's in turns.
    Returns the three kernel records."""
    from hyperion_tpu_torch.ops import flash_attention as fa

    dtype = q.dtype
    fwd = [fa.flash_attention_fwd(q, k, v, causal=causal, padding_mask=pad)
           for _ in range(2)]
    o, lse = fwd[0]
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            padding_mask=pad)
    dq = fa.flash_attention_dq(q, k, v, o, lse, do, causal=causal,
                               padding_mask=pad)
    dk, dv = fa.flash_attention_dkv(q, k, v, o, lse, do, causal=causal,
                                    padding_mask=pad)
    bwd = [fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  padding_mask=pad) for _ in range(2)]
    rdq, rdk, rdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 causal=causal,
                                                 padding_mask=pad)
    torch.cuda.synchronize()
    close = functools.partial(flash_close, dtype=dtype, D=q.shape[-1])
    checks = {"flash_attention_fwd": [close(o, ro, what="o"),
                                      close(lse, rlse, what="lse")],
              "flash_attention_dq": [close(dq, rdq, what="dq"),
                                     close(bwd[0][0], rdq, what="dq")],
              "flash_attention_dkv": [close(dk, rdk, what="dk"),
                                      close(dv, rdv, what="dv"),
                                      close(bwd[0][1], rdk, what="dk"),
                                      close(bwd[0][2], rdv, what="dv")]}
    deterministic = {"fwd": all(torch.equal(a, b) for a, b in zip(*fwd)),
                     "bwd": all(torch.equal(a, b) for a, b in zip(*bwd))}
    del ro, rlse, rdq, rdk, rdv, bwd, fwd
    B, T, H, D = q.shape
    base = {"phase": "kernels", "case": name,
            "dtype": str(dtype).split(".")[-1], "shape": list(q.shape),
            "causal": causal, "padded_keys": 0 if pad is None
            else int((pad == 0).sum())}
    recs = {}
    for kn, c in checks.items():
        which = kn.split("_")[-1]
        attrs = fa.kernel_attrs(which, D, dtype)
        ok = all(ok for ok, _ in c)
        # the Hopper kernels (bf16: three warpgroups, 384 threads), the
        # split-TF32 ones (fp32: 256 threads) and, past D 256, the wide
        # kernels of either dtype keep everything in registers; fp32's
        # wide kernels run on the cluster `wide_plan` computes for D, past
        # 2048 as their `_passes` twins
        if D > fa.WIDE and dtype == torch.float32:
            plan = fa.wide_plan(D)
            kind = attrs["function"] == f"flash_{which}_kernel_wide_tf32" + (
                "_passes" if plan["passes"] > 1 else "") \
                and attrs["cluster"] == plan["cluster"]
        elif D > fa.WIDE:
            kind = attrs["function"].startswith(f"flash_{which}_kernel_wide<")
        else:
            kind = (attrs["threads"] == 384) == (dtype == torch.bfloat16)
        ok = ok and not attrs["spill_bytes"] and kind
        # two runs of the forward, and of the backward, agree to the bit
        same = deterministic["fwd" if which == "fwd" else "bwd"]
        recs[kn] = {**base, "kernel": kn, **attrs,
                    "source": fa._entry((B, T, T, H, fa.kernel_head_dim(
                        D, dtype), D), which)[0] + ".cu",
                    "max_abs_err": max(e for _, e in c),
                    "deterministic": same, "ok": ok and same}
    if timing:
        it = q.element_size()
        n = q.numel() * it
        stats = B * H * T * 4
        pad_bytes = 0 if pad is None else pad.numel()
        pairs = flash_pairs(B, T, causal, pad)
        few = dict(calls=3, reps=2)  # the plain versions' [T, T] passes
        f, dqr, dkvr = (recs[k] for k in checks)
        nf = 4 * n + stats + pad_bytes
        f["kernel_ms"] = time_ms(
            lambda a, b, c: fa._launch_fwd(a, b, c, pad, causal, True),
            (q, k, v), nf)
        f["plain_ms"] = time_ms(
            lambda a, b, c: fa.flash_attention_fwd_plain(
                a, b, c, causal=causal, padding_mask=pad), (q, k, v), nf,
            **few)
        f["bound_ms"], f["bound_by"] = bound(nf, 4.0 * D * H * pairs, dtype)
        keep = torch.ones(T, T, dtype=torch.bool, device="cuda")
        if causal:
            keep = torch.tril(keep)
        mask4 = keep[None, None] if pad is None \
            else keep[None, None] & pad.bool()[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        f["library_backend"] = sdpa_backend(
            *(t.transpose(1, 2) for t in (q, k, v)), mask4)
        f["library_ms"] = time_ms(
            lambda a, b, c: sdpa(a.transpose(1, 2), b.transpose(1, 2),
                                 c.transpose(1, 2), attn_mask=mask4),
            (q, k, v), nf)
        # the launchers alone: dq computes delta (reading o) and hands it
        # to dk/dv
        dims, pad32, ins = fa._bwd_inputs(q, k, v, o, lse, do, pad)
        delta = fa._launch_dq(dims, pad32, *ins, causal)[1]
        ndq = ndkv = 6 * n + 2 * stats + pad_bytes  # each moves six [T, D]
        dqr["kernel_ms"] = time_ms(
            lambda *a: fa._launch_dq(dims, pad32, *a, causal), ins, ndq)
        dkvr["kernel_ms"] = time_ms(
            lambda *a: fa._launch_dkv(dims, pad32, *a, causal),
            (*ins, delta), ndkv)
        dqr["bound_ms"], dqr["bound_by"] = bound(ndq, 6.0 * D * H * pairs,
                                                 dtype)
        dkvr["bound_ms"], dkvr["bound_by"] = bound(ndkv, 8.0 * D * H * pairs,
                                                   dtype)
        # one plain backward and one library backward give all of dq,
        # dk and dv: both rows carry that whole time
        dqr["plain_ms"] = dkvr["plain_ms"] = time_ms(
            lambda a, b, c, oo, ll, g: fa.flash_attention_bwd_plain(
                a, b, c, oo, ll, g, causal=causal, padding_mask=pad),
            (q, k, v, o, lse, do), 6 * n + 2 * stats, **few)
        side_stream().wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side_stream()):  # the graph's stream
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_o = sdpa(*(t.transpose(1, 2) for t in leaves),
                         attn_mask=mask4)
        # the whole backward (delta included, as SDPA's own is) against
        # SDPA's, in turns: library, kernel, kernel, library
        nbwd = 8 * n + stats + pad_bytes
        turns = {"library": [], "kernel": []}
        for who in ("library", "kernel", "kernel", "library"):
            if who == "library":
                turns[who].append(replay_ms(
                    lambda lo, a, b, c, g: torch.autograd.grad(
                        lo, (a, b, c), g, retain_graph=True),
                    [(lib_o, *leaves, do.transpose(1, 2))]))
            else:
                turns[who].append(time_ms(
                    lambda a, b, c, oo, ll, g: fa.flash_attention_bwd(
                        a, b, c, oo, ll, g, causal=causal,
                        padding_mask=pad),
                    (q, k, v, o, lse, do), nbwd))
        dqr["library_ms"] = dkvr["library_ms"] = sum(turns["library"]) / 2
        whole = {**base, "kernel": "flash_attention_bwd",
                 "what": "dq + dk/dv launches, delta included",
                 "ms": turns["kernel"], "library_ms": turns["library"]}
        whole["bound_ms"], whole["bound_by"] = bound(
            nbwd, 10.0 * D * H * pairs, dtype)
        emit(whole)
        del leaves, lib_o, mask4
    for rec in recs.values():
        emit(rec)
    bad = [k for k, r in recs.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"flash attention {name} {dtype}: {bad} over "
                             "tolerance, not deterministic or spilling: " +
                             ", ".join(f"{k} {recs[k]['max_abs_err']}"
                                       for k in bad))
    return recs


def phase_flash() -> dict:
    """The flash kernels at the Llama-2-7B train step ([1, 4096, 32, 128]
    bf16, causal, the last quarter of the keys padding), fp32 causal and
    not at [2, 1024, 8, 128] and with q scaled by 4 (large logits), a
    ragged T = 1000, [2, 200, 8, 128] bf16 with one batch row all
    padding, bf16 at D 64 ([1, 4096, 8, 64] causal, the language_ddp
    heads at a length where "auto" picks flash), at D 32 ([1, 4096, 8,
    32] causal, run on the D 64 kernels at its own width) and [2, 1000,
    8, D] bf16 at D 80 and 96 (their own kernels;
    `check_flash_true_width`); the cross-entropy at Llama's [1, 4095, 32000] fp32 logits view; one
    train_long layer ([8, 4096, 4, 64] bf16, causal, ragged key padding
    drawn as the synthetic split draws it). Returns the records of the
    Llama step (flash and cross-entropy) and of the train_long layer for
    the `kernels` line, by run ("llama_train", "train_long")."""
    recs = check_flash("llama_train_step", *flash_case(
        1, 4096, 32, 128, torch.bfloat16, 0.25, SEED + 20), causal=True,
        timing=True)
    gc.collect()
    torch.cuda.empty_cache()
    for causal in (True, False):
        check_flash("fp32_causal" if causal else "fp32_full", *flash_case(
            2, 1024, 8, 128, torch.float32, 0.0, SEED + 21), causal=causal,
            timing=True)
    # large logits, where a TF32 term the fp32 kernels lost would show
    check_flash("fp32_scaled_q", *flash_case(
        2, 1024, 8, 128, torch.float32, 0.25, SEED + 26, q_scale=4.0),
        causal=True, timing=False)
    check_flash("ragged_1000", *flash_case(
        1, 1000, 8, 128, torch.bfloat16, 0.1, SEED + 22), causal=True,
        timing=True)
    # the Hopper forward's edges: T = 200, no multiple of its 128-row
    # blocks, and a batch row whose keys are all padding (every s NEG_INF,
    # o the mean of v over the keys; not causal, where the tiles a row
    # visits would decide it)
    check_flash("all_pad_row_200", *flash_case(
        2, 200, 8, 128, torch.bfloat16, (1.0, 0.1), SEED + 24), causal=False,
        timing=False)
    check_flash("d64_bf16_4096", *flash_case(
        1, 4096, 8, 64, torch.bfloat16, 0.0, SEED + 27), causal=True,
        timing=True)
    # one layer of the train_long step: its [8, 4096, 4, 64] under the
    # causal mask and the synthetic split's ragged key padding
    long_recs = check_flash("train_long_layer", *flash_case(
        8, 4096, 4, 64, torch.bfloat16, 0.0, SEED + 29)[:4],
        ragged_pad(8, 4096, SEED + 29), causal=True, timing=True)
    gc.collect()
    torch.cuda.empty_cache()
    check_flash("d32_bf16_4096", *flash_case(
        1, 4096, 8, 32, torch.bfloat16, 0.0, SEED + 28), causal=True,
        timing=True)
    # D 80 and 96 run kernels of their own (a 64-column box and a narrow
    # one a row), on the caller's tensors: the forward and whole backward
    # against the plain versions, each kernel launched, their times, the
    # launches' pointers and the bits of the D 128 kernel on padded copies
    for D in (80, 96):
        before = _flash_launches()
        case = flash_case(2, 1000, 8, D, torch.bfloat16, 0.1, SEED + 25)
        check_flash(f"d{D}_bf16", *case, causal=True, timing=True)
        check_flash_true_width(f"d{D}_bf16_true_width", *case, causal=True)
        rose = {k: n - before[k] for k, n in _flash_launches().items()}
        emit({"phase": "kernels", "kernel": "flash_attention", "case":
              f"d{D}_bf16_launches", "launches": rose})
        if not all(rose.values()):
            raise AssertionError(f"flash at D {D}: a kernel did not launch "
                                 f"({rose})")
    recs["fused_softmax_xent_fwd"], recs["fused_softmax_xent_bwd"] = \
        check_ce("llama_step_view_1x4095", *ce_case(
            1, 4095, 32000, torch.float32, SEED + 23, strided=True),
            timing=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"llama_train": recs, "train_long": long_recs,
            **phase_flash_d256()}


def phase_flash_d256() -> dict:
    """The D 256 kernels (bf16 on the Hopper kernels, fp32 on the
    split-TF32 ones) at the tolerances of the D 128 cases: the
    Llama-step masks at [1, 4096, 8, 256] (causal, the last 1024 keys
    padding; H x D is half of Llama's 32 x 128), a ragged T = 1000 with
    100 keys padding, [2, 200, 8, 256] not causal with one batch row all
    padding, fp32 [2, 1024, 8, 256] causal and full and with q scaled by
    4, fp32 at a ragged T = 1000 with 100 keys padding and [2, 200, 8,
    256] not causal with one batch row all padding (untimed), D 160 and
    192 on the D 256 kernels at their own widths (each
    kernel launched; `check_flash_true_width`), and one layer of
    `phase_lm_d256`'s step ([2, 4096, 4, 256], causal, ragged
    key padding), in bf16 and in fp32 (the step's two dtypes). Returns
    the step layer's records ("lm_d256", "lm_d256_fp32") and the fp32
    causal case's ("flash_d256_fp32") for the `kernels` line."""
    bf16, fp32 = torch.bfloat16, torch.float32
    check_flash("d256_bf16_4096", *flash_case(
        1, 4096, 8, 256, bf16, 0.25, SEED + 40), causal=True, timing=True)
    check_flash("d256_ragged_1000", *flash_case(
        2, 1000, 8, 256, bf16, 0.1, SEED + 41), causal=True, timing=True)
    check_flash("d256_all_pad_row_200", *flash_case(
        2, 200, 8, 256, bf16, (1.0, 0.1), SEED + 42), causal=False,
        timing=False)
    gc.collect()
    torch.cuda.empty_cache()
    fp32_recs = {}
    for causal in (True, False):
        fp32_recs[causal] = check_flash(
            "d256_fp32_causal" if causal else "d256_fp32_full", *flash_case(
                2, 1024, 8, 256, fp32, 0.0, SEED + 43), causal=causal,
            timing=True)
    check_flash("d256_fp32_scaled_q", *flash_case(
        2, 1024, 8, 256, fp32, 0.25, SEED + 44, q_scale=4.0), causal=True,
        timing=False)
    # the fp32 forward's edges: a ragged T (no multiple of its 64-row
    # blocks or 16-key tiles) with key padding, and a batch row whose keys
    # are all padding (not causal: o the mean of v over the keys)
    check_flash("d256_fp32_ragged_1000", *flash_case(
        2, 1000, 8, 256, fp32, 0.1, SEED + 49), causal=True, timing=False)
    check_flash("d256_fp32_all_pad_row_200", *flash_case(
        2, 200, 8, 256, fp32, (1.0, 0.1), SEED + 50), causal=False,
        timing=False)
    # D 160 and 192 run the D 256 kernels on the caller's tensors, the
    # columns past D read as zeros: bit-identical to host-padded copies
    for D in (160, 192):
        before = _flash_launches()
        case = flash_case(2, 1000, 8, D, bf16, 0.1, SEED + 45)
        check_flash(f"d{D}_bf16", *case, causal=True, timing=True)
        check_flash_true_width(f"d{D}_bf16_true_width", *case, causal=True)
        rose = {k: n - before[k] for k, n in _flash_launches().items()}
        emit({"phase": "kernels", "kernel": "flash_attention", "case":
              f"d{D}_bf16_launches", "launches": rose})
        if not all(rose.values()):
            raise AssertionError(f"flash at D {D}: a kernel did not launch "
                                 f"({rose})")
    gc.collect()
    torch.cuda.empty_cache()
    step = {}
    for run, dtype, seed in (("lm_d256", bf16, SEED + 46),
                             ("lm_d256_fp32", fp32, SEED + 51)):
        step[run] = check_flash(
            "lm_d256_layer" + run[len("lm_d256"):], *flash_case(
                *LM_D256_SHAPE, dtype, 0.0, seed)[:4],
            ragged_pad(LM_D256_SHAPE[0], LM_D256_SHAPE[1], seed),
            causal=True, timing=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {**step, "flash_d256_fp32": fp32_recs[True]}


def _flash_launches() -> dict:
    from hyperion_tpu_torch.ops import flash_attention as fa

    return {f.__name__: f.launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv)}


@contextlib.contextmanager
def flash_entry_args():
    """Records (entry point, its first three arguments: the q, k and v
    pointers) of every flash-attention C launch made inside."""
    from hyperion_tpu_torch.ops import build

    seen, real = [], build.function

    def function(stem, name, argtypes):
        fn = real(stem, name, argtypes)
        if stem != "flash_attention":
            return fn

        def launch(*args):
            seen.append((name, tuple(args[:3])))
            return fn(*args)
        return launch

    build.function = function
    try:
        yield seen
    finally:
        build.function = real


def _flash_launch_all(dims, pad, q, k, v, g, causal):
    """(o, lse, dq, dk, dv) from the three launchers on inputs of the
    launch's width, sliced to the true D of `dims`."""
    from hyperion_tpu_torch.ops import flash_attention as fa

    o, lse = fa._run_fwd(dims, pad, q, k, v, causal, True)
    o = fa._unpad(o, dims[5])
    ins = [fa.pad_head_dim(t, q.shape[-1]) for t in (q, k, v, g, o)]
    dq, delta = fa._launch_dq(dims, pad, *ins, lse, causal)
    dk, dv = fa._launch_dkv(dims, pad, *ins, lse, delta, causal)
    return o, lse, dq, dk, dv


def check_flash_true_width(name, q, k, v, do, pad, causal) -> dict:
    """bf16 at a head dim D that is a multiple of 8 reaches the kernels in
    place: the forward and the whole backward through the public wrappers
    launch on the caller's own q, k and v (their pointers recorded at the
    C entry points), and the launchers' o, lse, dq, dk and dv are
    bit-identical to the same kernel's on host-padded copies of the
    kernel's width (D 160, 192: the D 256 kernels), or, where D has a
    kernel of its own (80, 96), to the D 128 kernel's on copies padded to
    128. Raises unless both hold."""
    from hyperion_tpu_torch.ops import flash_attention as fa

    D = q.shape[-1]
    with flash_entry_args() as seen:
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        padding_mask=pad)
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               padding_mask=pad)
    in_place = len(seen) == 3 and all(
        args == (q.data_ptr(), k.data_ptr(), v.data_ptr()) for _, args in seen)
    dims, pad32 = fa._check(q, k, v, pad)
    ref_k = dims[4] if dims[4] > D else 128
    got = _flash_launch_all(dims, pad32, q, k, v, do, causal)
    want = _flash_launch_all((*dims[:4], ref_k, D), pad32, *(
        fa.pad_head_dim(t, ref_k) for t in (q, k, v, do)), causal)
    same = {w: bool(torch.equal(a, b)) for w, a, b in
            zip(("o", "lse", "dq", "dk", "dv"), got, want)}
    rec = {"phase": "kernels", "kernel": "flash_attention", "case": name,
           "head_dim": D, "kernel_head_dim": dims[4],
           "host_padded": fa.host_padded(D, q.dtype),
           "launches_took_caller_storage": in_place,
           "launches_seen": [n for n, _ in seen],
           "bit_identical_to": f"the D {ref_k} kernel on inputs padded to "
                               f"{ref_k}", "bit_identical": same}
    emit(rec)
    if not in_place or not all(same.values()):
        raise AssertionError(f"flash at D {D}: in place {in_place}, "
                             f"bit-identical {same}")
    return rec


def ckpt_readings(base: Path, job_dir: str) -> dict:
    """A training run's checkpoint readings from its telemetry and its
    newest step dir: each save's dispatch and commit seconds (the
    `ckpt_dispatch` and `ckpt_commit` spans; an async save's commit is
    the wait for its write at the next save or the run's exit, and its
    manifest), each restore's seconds (`ckpt_restore`), the newest
    step's bytes (its manifest's files) and whether it deep-verifies."""
    from hyperion_tpu_torch.checkpoint import integrity

    recs = [json.loads(x) for x in
            (base / "telemetry.jsonl").read_text().splitlines()]

    def secs(name):
        return [r["dur_ms"] / 1e3 for r in recs
                if r.get("kind") == "span" and r.get("name") == name]

    steps = sorted((base / "checkpoints" / job_dir).glob("step_*[0-9]"))
    newest = steps[-1] if steps else None
    manifest = integrity.read_manifest(newest) if newest else None
    return {"dispatch_s": secs("ckpt_dispatch"),
            "commit_s": secs("ckpt_commit"),
            "restore_s": secs("ckpt_restore"),
            "newest": newest.name if newest else None,
            "bytes": sum(f["bytes"] for f in manifest["files"])
            if manifest else None,
            "verified": bool(newest) and integrity.verify(newest)[0]}


def gauge_readings(res) -> dict:
    """The run's last per-epoch gauges: MFU (against the H100's datasheet
    peak, `utils/chips.py`), FLOPs a step, input wait, throughput."""
    g = res.metrics.get("gauges", {})
    return {k: g.get(k) for k in ("mfu", "flops_per_step", "input_wait_frac",
                                  "step_time_fenced_ms", "tokens_per_s")} \
        | {"mfu_peak_source": res.metrics.get("labels", {}).get(
            "mfu_peak_source")}


def train_problems(name: str, ckpt: dict, gauges: dict) -> list[str]:
    """The checks every training phase makes of its checkpoint and
    gauges: a verified epoch-boundary checkpoint, an MFU in (0, 1)
    against the datasheet peak."""
    out = []
    if not (ckpt["verified"] and ckpt["bytes"] and ckpt["dispatch_s"]):
        out.append(f"{name}: checkpoint {ckpt}")
    if not (gauges["mfu"] and 0 < gauges["mfu"] < 1
            and gauges["mfu_peak_source"] == "nominal"):
        out.append(f"{name}: mfu {gauges}")
    return out


TINY_LM = dict(vocab_size=1000, d_model=32, n_heads=2, n_layers=2,
               ff_dim=64, max_len=16, dropout=0.0)


def phase_train_model() -> None:
    """A tiny fp32 TransformerLM on the CPU (plain versions) against the
    same weights on the card (kernels): logits, loss and every
    parameter's gradient within 2e-5."""
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )
    from hyperion_tpu_torch.ops.fused_ce import (
        fused_softmax_xent_bwd,
        fused_softmax_xent_fwd,
    )
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
    from hyperion_tpu_torch.train.losses import next_token_loss

    cfg = simple_lm_config(norm_impl="pallas", **TINY_LM)
    cpu = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    gpu = TransformerLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(SEED + 15)
    B, T = 4, 16
    ids = torch.as_tensor(rng.integers(0, 1000, (B, T)), dtype=torch.int32)
    mask = torch.as_tensor(np.arange(T)[None] < np.array([T, 12, 9, 16])[
        :, None], dtype=torch.int8)
    before = (fused_layernorm.launches, fused_softmax_xent_fwd.launches,
              fused_softmax_xent_bwd.launches)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        logits = model(ids.to(dev), padding_mask=mask.to(dev))
        loss = next_token_loss(logits, ids.to(dev), mask.to(dev),
                               impl="pallas")
        loss.backward()
        out[dev] = (logits.detach().cpu(), loss.detach().cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    launched = (fused_layernorm.launches - before[0],
                fused_softmax_xent_fwd.launches - before[1],
                fused_softmax_xent_bwd.launches - before[2])
    errs = {"logits": float((out["cpu"][0] - out["cuda"][0]).abs().max()),
            "loss": float((out["cpu"][1] - out["cuda"][1]).abs())}
    errs["grads"] = max(float((a - out["cuda"][2][n]).abs().max())
                        for n, a in out["cpu"][2].items())
    ok = (all(torch.allclose(a, c, atol=2e-5, rtol=2e-5)
              for a, c in zip(out["cpu"][:2], out["cuda"][:2]))
          and all(torch.allclose(a, out["cuda"][2][n], atol=2e-5, rtol=2e-5)
                  for n, a in out["cpu"][2].items()))
    emit({"phase": "train_model", "max_abs_err": errs, "tol": 2e-5,
          "launches": launched, "ok": ok})
    if not ok or launched != (2 * cfg.n_layers + 1, 1, 1):
        raise AssertionError(f"train_model: errors {errs}, launches "
                             f"{launched}")


def train_config(base: Path, steps: int = 50):
    """The language_ddp trainer's defaults at jit+pallas, one epoch of
    `steps` steps, writing under `base` (emptied first) and reading its
    data from an empty directory there: the synthetic splits."""
    import shutil

    from hyperion_tpu_torch.config import Config

    shutil.rmtree(base, ignore_errors=True)
    (base / "no_data").mkdir(parents=True)
    cfg = Config()
    cfg.train.epochs = 1
    cfg.train.steps_per_epoch = steps
    cfg.train.base_dir = str(base)
    cfg.train.data_dir = str(base / "no_data")
    cfg.optimization.compile_tier = "jit+pallas"
    assert (cfg.train.batch_size, cfg.train.seq_len,
            cfg.optimization.precision) == (32, 128, "bf16")
    return cfg


def phase_train(smi: str) -> dict:
    """`train_language_model` on the card: language_ddp widths, bf16,
    jit+pallas, batch 32, seq 128, one epoch of 50 steps, dropout 0.1,
    validation on the synthetic split."""
    from hyperion_tpu_torch.checkpoint.io import load_gathered
    from hyperion_tpu_torch.ops.fused_ce import (
        fused_softmax_xent_bwd,
        fused_softmax_xent_fwd,
    )
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
    from hyperion_tpu_torch.train.trainer import train_language_model

    base = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    cfg = train_config(base)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_layernorm.launches = 0
    fused_softmax_xent_fwd.launches = 0
    fused_softmax_xent_bwd.launches = 0
    t0 = time.perf_counter()
    res = train_language_model(cfg)
    wall = time.perf_counter() - t0
    launches = {"fused_layernorm": fused_layernorm.launches,
                "fused_softmax_xent_fwd": fused_softmax_xent_fwd.launches,
                "fused_softmax_xent_bwd": fused_softmax_xent_bwd.launches}

    spans = [json.loads(x) for x in
             (base / "telemetry.jsonl").read_text().splitlines()]
    eval_batches = sum(r.get("batches", 0) for r in spans
                       if r.get("name") == "eval")
    steps = len(res.step_losses)
    losses = np.asarray(res.step_losses)
    with open(res.csv_path) as f:
        rows = list(csv.reader(f))
    exported = load_gathered(base / "checkpoints" / "language_ddp_final.npz")
    step_ms = np.asarray(res.step_ms)
    p50 = float(np.percentile(step_ms, 50))
    rec = {
        "phase": "train", "nvidia_smi": smi, "wall_s": wall,
        "steps": steps, "eval_batches": eval_batches,
        "loss_first10": float(losses[:10].mean()),
        "loss_last10": float(losses[-10:].mean()),
        "final_loss": res.final_loss,
        "val_loss": res.history[-1].extra.get("val_loss"),
        "epoch_s": res.history[-1].duration_s,
        "step_ms_p50": p50, "step_ms_min": float(step_ms.min()),
        "step_ms_max": float(step_ms.max()),
        "tokens_per_s": 32 * 128 / (p50 / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "csv_header": rows[0], "csv_rows": len(rows) - 1,
        "launches": launches,
        "launches_expected": {
            "fused_layernorm": 5 * (steps + eval_batches),
            "fused_softmax_xent_fwd": steps + eval_batches,
            "fused_softmax_xent_bwd": steps},
        "checkpoint": ckpt_readings(base, "language_ddp_1dev"),
        "gauges": gauge_readings(res),
    }
    emit(rec)
    problems = train_problems("train", rec["checkpoint"], rec["gauges"])
    if steps != 50 or eval_batches != 14:
        problems.append(f"{steps} steps, {eval_batches} eval batches")
    if not (np.isfinite(losses).all() and np.isfinite(rec["val_loss"])):
        problems.append("non-finite loss")
    if not rec["loss_last10"] < rec["loss_first10"]:
        problems.append("loss did not fall")
    if rows[0] != ["epoch", "loss", "duration_s", "gpus", "val_loss",
                   "val_ppl"] or len(rows) != 2:
        problems.append(f"csv {rows}")
    if exported["lm_head"]["kernel"].shape != (256, 50257):
        problems.append("export does not reload at the model's shapes")
    if launches != rec["launches_expected"]:
        problems.append(f"launch counts {launches} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
    return rec


LONG_STEPS, LONG_BATCH, LONG_SEQ = 30, 8, 4096
# the D 256 step (phase_lm_d256): batch, seq, heads, head_dim
LM_D256_SHAPE = (2, 4096, 4, 256)


def long_train_config(base: Path, steps: int = LONG_STEPS):
    """The language_ddp trainer at 4096 tokens: `train_config`'s defaults
    (d 256 over 4 heads, so head_dim 64; 2 layers; GPT-2 vocab; bf16 over
    fp32 masters; dropout 0.1; jit+pallas; the synthetic splits) with
    seq_len 4096, where "auto" attention resolves to the flash kernels,
    and batch 8 (32,768 tokens a step, against 4,096 at 32 x 128). Cut
    to one epoch of `steps` steps; validation takes as many batches of
    its 58 (the trainer caps it at the step count)."""
    cfg = train_config(base, steps=steps)
    cfg.train.seq_len, cfg.train.batch_size = LONG_SEQ, LONG_BATCH
    return cfg


def phase_train_long(smi: str) -> dict:
    """`train_language_model` on the card at 4096 tokens
    (`long_train_config`): every layer's attention runs the flash kernels
    at head_dim 64 (the D 64 Hopper kernels), with the synthetic split's
    ragged key padding under the causal mask. Every loss finite, the last
    10 steps' mean below the first 10's, and every kernel's launches
    exact: flash forward layers x (steps + evals), dq = dk/dv = layers x
    steps, LayerNorm 5 x (steps + evals), cross-entropy forward steps +
    evals and backward steps. Step time p50 (CUDA events), tokens/s and
    peak memory are smoke readings."""
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
    from hyperion_tpu_torch.train.trainer import train_language_model

    base = Path(__file__).resolve().parent / "build" / "chip_smoke_train_long"
    cfg = long_train_config(base)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    fused_layernorm.launches = 0
    t0 = time.perf_counter()
    res = train_language_model(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**_launch_counts(), "fused_layernorm": fused_layernorm.launches}
    peak = torch.cuda.max_memory_allocated()
    lm = res.model.cfg
    res.model = None
    gc.collect()
    torch.cuda.empty_cache()

    spans = [json.loads(x) for x in
             (base / "telemetry.jsonl").read_text().splitlines()]
    evals = sum(r.get("batches", 0) for r in spans if r.get("name") == "eval")
    steps = len(res.step_losses)
    losses = np.asarray(res.step_losses)
    step_ms = np.asarray(res.step_ms)
    p50 = float(np.percentile(step_ms, 50))
    tokens = cfg.train.batch_size * cfg.train.seq_len
    rec = {
        "phase": "train_long", "nvidia_smi": smi, "wall_s": wall,
        "seq_len": cfg.train.seq_len, "batch": cfg.train.batch_size,
        "head_dim": lm.d_model // lm.n_heads, "layers": lm.n_layers,
        "steps": steps, "eval_batches": evals,
        "loss_first10": float(losses[:10].mean()),
        "loss_last10": float(losses[-10:].mean()),
        "val_loss": res.history[-1].extra.get("val_loss"),
        "losses": losses.tolist(), "step_ms": step_ms.tolist(),
        "step_ms_p50": p50,
        "tokens_per_s": tokens / (p50 / 1e3), "peak_mem_gb": peak / 1e9,
        "launches": launches,
        "launches_expected": {
            "flash_attention_fwd": lm.n_layers * (steps + evals),
            "flash_attention_dq": lm.n_layers * steps,
            "flash_attention_dkv": lm.n_layers * steps,
            "fused_rmsnorm": 0,
            "fused_rmsnorm_bwd": 0,
            "fused_softmax_xent_fwd": steps + evals,
            "fused_softmax_xent_bwd": steps,
            "fused_layernorm": 5 * (steps + evals)},
        "checkpoint": ckpt_readings(base, "language_ddp_1dev"),
        "gauges": gauge_readings(res),
    }
    emit(rec)
    problems = train_problems("train_long", rec["checkpoint"], rec["gauges"])
    if (steps, evals, rec["head_dim"]) != (LONG_STEPS, LONG_STEPS, 64):
        problems.append(f"{steps} steps, {evals} eval batches, head_dim "
                        f"{rec['head_dim']}")
    if not (np.isfinite(losses).all() and np.isfinite(rec["val_loss"])):
        problems.append("non-finite loss")
    if not rec["loss_last10"] < rec["loss_first10"]:
        problems.append("loss did not fall")
    if launches != rec["launches_expected"]:
        problems.append(f"launch counts {launches} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("train_long: " + "; ".join(problems))
    return rec


def lm_step(smi: str, shape: tuple, phase: str, seed: int, steps: int = 1
            ) -> tuple[dict, list[str]]:
    """One forward and backward of the port's TransformerLM at heads
    `shape` = (B, T, H, D): d_model H * D, 2 layers, GPT-2 vocab, the
    synthetic split's ragged key padding, `attention_impl="pallas"` in
    bf16 and fp32 against "xla" in bf16, fp32 and float64 on the same
    weights; the record and the bounds it misses (`phase_lm_d256` says
    why each bound holds). Launches counted per dtype: 2 forward, 2 dq,
    2 dk/dv, in the first timed step. `steps` timed steps a model after
    one warm one (CUDA events around each), `step_ms` their median."""
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )
    from hyperion_tpu_torch.train.losses import next_token_loss

    B, T, H, D = shape
    kw = dict(vocab_size=50257, d_model=H * D, n_heads=H, n_layers=2,
              ff_dim=4 * H * D, max_len=T, dropout=0.0, dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed)
    models = {"pallas": TransformerLM(simple_lm_config(
        **kw, attention_impl="pallas"), device="cuda").init_params(g)}
    models["xla"] = TransformerLM(simple_lm_config(
        **kw, attention_impl="xla"), device="cuda")
    models["xla"].load_state_dict(models["pallas"].state_dict())
    models["fp32"] = TransformerLM(simple_lm_config(
        **{**kw, "dtype": "float32"}, attention_impl="xla"), device="cuda")
    models["fp32"].load_state_dict(models["pallas"].state_dict())
    models["fp32_pallas"] = TransformerLM(simple_lm_config(
        **{**kw, "dtype": "float32"}, attention_impl="pallas"), device="cuda")
    models["fp32_pallas"].load_state_dict(models["pallas"].state_dict())
    models["fp64"] = TransformerLM(simple_lm_config(
        **{**kw, "dtype": "float64"}, attention_impl="xla"), device="cuda")
    models["fp64"].load_state_dict(models["pallas"].state_dict())
    ids = torch.randint(0, 50257, (B, T), generator=g, device="cuda")
    mask = ragged_pad(B, T, seed)

    def step(model):
        model.zero_grad(set_to_none=True)
        loss = next_token_loss(model(ids, padding_mask=mask), ids, mask)
        loss.backward()
        return loss

    out, launches = {}, {}
    for impl, model in models.items():
        step(model)  # warm
        torch.cuda.synchronize()
        times = []
        for i in range(steps):
            if i == 0:
                _reset_launch_counts()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            loss = step(model)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            if i == 0:
                launches[impl] = _flash_launches()
        out[impl] = {"loss": loss.item(), "step_ms": float(np.median(times)),
                     "step_ms_all": times,
                     "grads": {n: p.grad.float() for n, p in
                               model.named_parameters()}}
    leaves = [n for n in out["xla"]["grads"] if not n.endswith("k_proj.bias")]
    rel = {n: float((out["pallas"]["grads"][n] - out["xla"]["grads"][n])
                    .norm() / out["xla"]["grads"][n].norm().clamp_min(1e-30))
           for n in leaves}

    def off(impl, ref="fp32"):  # |g_impl - g_ref| / |g_ref| over every leaf
        d2 = sum(float((out[impl]["grads"][n] - out[ref]["grads"][n])
                       .norm()) ** 2 for n in leaves)
        r2 = sum(float(out[ref]["grads"][n].norm()) ** 2 for n in leaves)
        return math.sqrt(d2 / r2)
    fp32_bounds = {"loss": 2 * 2e-5 * fp32_flash_growth(D),
                   "grad": 5 * off("fp32", "fp64")}
    k_bias = {impl: [float(o["grads"][n].norm()) for n in o["grads"]
                     if n.endswith("k_proj.bias")] for impl, o in out.items()}
    finite = all(bool(t.isfinite().all())
                 for o in out.values() for t in o["grads"].values())
    rec = {"phase": phase, "nvidia_smi": smi, "shape": [B, T],
           "heads": H, "head_dim": D, "layers": 2, "dtype": "bfloat16",
           "loss": {k: o["loss"] for k, o in out.items()},
           "step_ms": {k: o["step_ms"] for k, o in out.items()},
           "step_ms_all": {k: o["step_ms_all"] for k, o in out.items()},
           "grad_rel_norm_max": max(rel.values()),
           "grad_rel_worst": max(rel, key=rel.get),
           "grad_rel_norm": {n: round(v, 6) for n, v in rel.items()},
           "grad_off_fp32": {k: off(k)
                             for k in ("pallas", "xla", "fp32_pallas")},
           "grad_off_fp64": {k: off(k, "fp64")
                             for k in ("fp32", "fp32_pallas")},
           "fp32_pallas_loss_off": abs(out["fp32_pallas"]["loss"] -
                                       out["fp32"]["loss"]) /
           abs(out["fp32"]["loss"]),
           "fp32_pallas_bounds": fp32_bounds,
           "k_proj_bias_grad_norm": k_bias, "finite": finite,
           "launches": launches["pallas"],
           "launches_fp32_pallas": launches["fp32_pallas"],
           "launches_expected": {"flash_attention_fwd": 2,
                                 "flash_attention_dq": 2,
                                 "flash_attention_dkv": 2}}
    del models, out
    gc.collect()
    torch.cuda.empty_cache()
    problems = []
    if not finite or not all(math.isfinite(v) for v in rec["loss"].values()):
        problems.append("non-finite loss or gradient")
    if abs(rec["loss"]["pallas"] - rec["loss"]["xla"]) \
            > 2.0 ** -6 * abs(rec["loss"]["xla"]):
        problems.append(f"loss {rec['loss']}")
    if rec["grad_off_fp32"]["pallas"] > rec["grad_off_fp32"]["xla"]:
        problems.append(f"gradient further from fp32's than the plain "
                        f"bf16 step's: {rec['grad_off_fp32']}")
    if rec["fp32_pallas_loss_off"] > fp32_bounds["loss"] or \
            rec["grad_off_fp32"]["fp32_pallas"] > fp32_bounds["grad"]:
        problems.append(f"fp32 step on the kernels off the fp32 xla step: "
                        f"loss {rec['fp32_pallas_loss_off']}, gradient "
                        f"{rec['grad_off_fp32']['fp32_pallas']} "
                        f"(bounds {fp32_bounds})")
    for impl in ("pallas", "fp32_pallas"):
        if launches[impl] != rec["launches_expected"]:
            problems.append(f"{impl} launches {launches[impl]}")
    return rec, problems


def phase_lm_d256(smi: str) -> dict:
    """One forward and backward of the port's TransformerLM at head_dim
    256 through its existing config fields (d_model 1024, 4 heads, 2
    layers, GPT-2 vocab, bf16, `attention_impl="pallas"`) at batch 2 and
    seq 4096 with the synthetic split's ragged key padding, held against
    the same weights at `attention_impl="xla"` (bf16) and, as the
    measure of both, at "xla" in fp32. The flash launches of the pallas
    step are counted: 2 forward, 2 dq, 2 dk/dv.

    The two bf16 steps differ only in where bf16 rounds inside
    attention: the "xla" path rounds the logits, p . v, dp = dO . v^T and
    the products after it to bf16; the kernels keep s and dp in fp32 and
    round p and ds once. So the loss (a mean over 8k tokens) agrees to
    2^-6 of itself. The gradients do not agree to a fixed share: ds =
    p (dp - delta) cancels, and the "xla" path rounds dp to bf16 before
    that subtraction, which scales its error by |dp| / |dp - delta| (the
    2^-4 of each leaf's norm first set here was exceeded at 6.5 %). What
    is held instead is that the kernels' step is at least as close to
    the fp32 step as the plain bf16 step is: over all the gradient
    (every leaf but k_proj's bias, as one vector), |g_pallas - g_fp32|
    <= |g_xla - g_fp32|. k_proj's bias is left out: it adds one constant
    to every logit of a row, which the softmax cancels, so its gradient
    is zero in exact arithmetic and each side's is rounding noise (its
    norms are recorded).

    A fourth model, fp32 at `attention_impl="pallas"` on the same weights
    and batch, runs the fp32 D 256 kernels (2 forward, 2 dq, 2 dk/dv
    launches) against the fp32 "xla" step, and a fifth, "xla" in float64
    (its softmax and loss in fp32, as that path computes them), measures
    both. The kernels hold o within 2e-5 x 2.83 of the plain attention
    (`fp32_flash_growth(256)`), and each of the two layers' attention
    adds that share of itself to the residual stream: the loss agrees
    within 2 x 2e-5 x 2.83 of itself. The gradient does not follow the
    kernels' elementwise bounds that way (the 2 x 2e-4 x 2.83 of its norm
    first set here was exceeded at 1.6e-3: the plain fp32 step itself
    sits 9e-4 from the float64 one, the model magnifying every rounding).
    What is held instead comes from the kernels' arithmetic: a split-TF32
    product term is exact to 2^-22 of itself where fp32 rounds to 2^-24,
    so the kernels' step may sit up to 4 times as far from float64's as
    the plain fp32 step, and by the triangle inequality |g_pallas32 -
    g_fp32| <= 5 |g_fp32 - g_fp64| over all the gradient (every leaf but
    k_proj's bias, as one vector). Its step time is printed beside the
    fp32 "xla" twin's.

    Then the public entry in fp32 (`flash_attention` at [2, 1024, 8,
    256], causal, forward and backward): the fp32 D 256 kernels launch
    once each and the gradients hold the fp32 bounds (2e-4) of the plain
    autograd. Returns {"lm_d256": ..., "flash_d256_fp32": ...} with each
    run's launches."""
    from hyperion_tpu_torch.ops import flash_attention as fa

    rec, problems = lm_step(smi, LM_D256_SHAPE, "lm_d256", SEED + 47)
    emit(rec)

    # the public entry in fp32
    q, k, v, do, pad = flash_case(2, 1024, 8, 256, torch.float32, 0.25,
                                  SEED + 48)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    _reset_launch_counts()
    fa.flash_attention(*leaves, causal=True, padding_mask=pad).backward(do)
    torch.cuda.synchronize()
    fp32_launches = _flash_launches()
    # the plain forward under autograd: its backward is autograd's over
    # the whole-matrix formula
    fa.flash_attention_fwd_plain(*plain, causal=True,
                                 padding_mask=pad)[0].backward(do)
    errs = [float((a.grad - b.grad).abs().max()) for a, b in
            zip(leaves, plain)]
    grads_ok = all(bool(((a.grad - b.grad).abs()
                         <= 2e-4 + 2e-4 * b.grad.abs()).all())
                   for a, b in zip(leaves, plain))
    fp32_rec = {"phase": "flash_d256_fp32", "shape": [2, 1024, 8, 256],
                "launches": fp32_launches,
                "launches_expected": {k: 1 for k in fp32_launches},
                "grad_max_abs_err": errs, "grads_ok": grads_ok}
    emit(fp32_rec)
    if fp32_launches != fp32_rec["launches_expected"] or not grads_ok:
        problems.append(f"fp32 public entry: {fp32_rec}")
    del q, k, v, do, pad, leaves, plain
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("lm_d256: " + "; ".join(problems))
    return {"lm_d256": rec, "flash_d256_fp32": fp32_rec}



# The head dims the kernels took only in part before: paged attention at
# D 8, 72 and 100 (the instantiations at 16, 80 and 112, read at the true
# width; bf16 D 100 is a 200-byte row, loaded in 8-byte units) and at 264,
# 320 and 512 (the wide kernel); flash attention past 256 (the wide
# kernels). The serve phases' Llamas: 2 layers, vocab 32000, heads of 72
# (32 over 8 KV heads) and of 320 (8 over 8).
ANY_D = (8, 72, 100, 264, 320, 512)
# flash past 256: 301 an odd row (4-byte units in fp32, 2-byte in bf16),
# 1032 past eight 128-column slices (fp32: a non-portable cluster of 9),
# 1928 and 2048 on the largest cluster, 16 (an 8-column last slice, and
# 16 full ones), 2305 past it in two passes (an odd row, its last slice
# one column)
WIDE_FLASH_D = (264, 301, 320, 512, 1032, 1928, 2048, 2305)
LM_D512_SHAPE = (2, 4096, 2, 512)
SERVE_HEAD_DIMS = {
    "serve_odd_d": dict(d_model=2304, n_heads=32, n_kv_heads=8, ff_dim=6144),
    "serve_wide_d": dict(d_model=2560, n_heads=8, n_kv_heads=8, ff_dim=6912)}


def sdpa_backend(q, k, v, mask) -> str:
    """The backend SDPA picks for a masked call on [B, H, T, D] tensors
    (torch's own dispatch rule, `_fused_sdp_choice`)."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, attn_mask=mask, dropout_p=0.0, is_causal=False)).name
    except (AttributeError, RuntimeError, TypeError) as e:  # a private rule
        return f"unknown ({type(e).__name__})"


def serve_tick_geometry(H, Hkv, D, dtype):
    """The serve phases' decode tick: [4, 1] over chains at the decode
    tick's ragged depths (`kernels_line`'s decode_tick_S4)."""
    rng = np.random.default_rng(SEED + 4)
    return paged_geometry(4, 1, H, Hkv, dtype, D=D,
                          base=rng.integers(32, 532, 4), seed=5)


def phase_any_head_dim() -> dict:
    """Every kernel at the head dims that it took only in part before,
    against its plain version: paged attention at decode [4, 1] and
    prefill [1, 512], both at base 256, 32 heads over 8 KV heads, at D 8,
    72, 100, 264, 320 and 512, in bf16 and fp32, with the null-block
    poison and a rerun at each D; flash attention's forward, dq and
    dk/dv at each of `WIDE_FLASH_D` on [2, 1000, 4, D] causal with
    the synthetic split's ragged key padding and [2, 200, 4, D] full with
    one batch row all padding, bf16 and fp32 (`check_flash`: the bounds
    of the D <= 256 cases, fp32's grown by `fp32_flash_growth(D)`; two
    runs bit-identical; no spill; fp32 on `wide_plan`'s cluster). Timed
    at the new phases' shapes: paged attention at serve_odd_d's and
    serve_wide_d's decode ticks, flash at one lm_d512 layer ([2, 4096, 2,
    512], causal, ragged padding) in each dtype, beside SDPA's masked
    call (`library_backend` names the backend it picked). Returns the
    timed records by run."""
    t0 = time.perf_counter()
    bf16, fp32 = torch.bfloat16, torch.float32
    for dtype in (bf16, fp32):
        for D in ANY_D:
            check_paged(f"decode_4x1_d{D}", paged_geometry(
                4, 1, 32, 8, dtype, D=D, base=[256] * 4, seed=70 + D), dtype,
                timing=False)
            check_paged(f"prefill_1x512_d{D}", paged_geometry(
                1, 512, 32, 8, dtype, D=D, base=[256], seed=71 + D), dtype,
                timing=False)
            check_poison(dtype, D)
        gc.collect()
        torch.cuda.empty_cache()
        for D in WIDE_FLASH_D:
            check_flash(f"d{D}_ragged_1000", *flash_case(
                2, 1000, 4, D, dtype, 0.0, SEED + 60 + D)[:4],
                ragged_pad(2, 1000, SEED + 60 + D), causal=True, timing=False)
            check_flash(f"d{D}_all_pad_row_200", *flash_case(
                2, 200, 4, D, dtype, (1.0, 0.1), SEED + 61 + D),
                causal=False, timing=False)
    recs = {}
    for run, cfg in SERVE_HEAD_DIMS.items():
        H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
        D = cfg["d_model"] // H
        # the serve phases run fp32, as their streams are compared
        recs[run] = {"paged_attention": check_paged(
            f"{run}_decode_tick_S4", serve_tick_geometry(H, Hkv, D, fp32),
            fp32, timing=True)}
    gc.collect()
    torch.cuda.empty_cache()
    for run, dtype, seed in (("lm_d512", bf16, SEED + 80),
                             ("lm_d512_fp32", fp32, SEED + 81)):
        recs[run] = check_flash(
            "lm_d512_layer" + run[len("lm_d512"):], *flash_case(
                *LM_D512_SHAPE, dtype, 0.0, seed)[:4],
            ragged_pad(LM_D512_SHAPE[0], LM_D512_SHAPE[1], seed),
            causal=True, timing=True)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "any_head_dim", "seconds": round(time.perf_counter() - t0,
                                                    3)})
    return recs


def phase_lm_d512(smi: str) -> dict:
    """`phase_lm_d256`'s step at head_dim 512 (`lm_step`: d_model 1024
    over 2 heads, 2 layers, GPT-2 vocab, batch 2, seq 4096, ragged
    padding), on the wide flash kernels, with its bounds: the bf16 kernel
    step at least as close to the fp32 "xla" step as the bf16 "xla" one;
    the fp32 kernel step's loss within 2 x 2e-5 x fp32_flash_growth(512)
    of the fp32 "xla" step's, its gradient within 5 times the fp32 step's
    distance from float64's. The growth (D / 128)^1.5 = 8 holds for these
    kernels as for the D <= 256 split-TF32 ones: their products are the
    same three TF32 passes, whose dot product over D is off by at most ~D
    u sum|q_d k_d|, the bound the factor comes from (the cluster's
    partial sums over D's slices are terms of that one sum), and the
    triangle bound on the gradient needs only that their terms are no
    worse than the plain step's. Each step is the median of 3; whether
    the fp32 kernel step is below its "xla" twin's in the same run is
    recorded (`fp32_kernels_below_xla`), not held: at this layer the
    kernels' forward and backward take longer than the twin's attention
    in plain fp32 matmuls (PERF.md section 6). 2 forward, 2 dq and 2
    dk/dv launches in each dtype."""
    t0 = time.perf_counter()
    rec, problems = lm_step(smi, LM_D512_SHAPE, "lm_d512", SEED + 82,
                            steps=3)
    rec["fp32_kernels_below_xla"] = \
        rec["step_ms"]["fp32_pallas"] < rec["step_ms"]["fp32"]
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    emit(rec)
    if problems:
        raise AssertionError("lm_d512: " + "; ".join(problems))
    return rec


def serve_head_dim_requests(rng) -> list[dict]:
    """Four greedy requests, prompts of 24, 41, 57 and 90 tokens (the
    128-token bucket warms them), 16 new tokens each."""
    return [{"id": f"h{i}", "prompt_ids": rng.integers(1, 32000, n)
             .astype(int).tolist(), "max_new_tokens": 16}
            for i, n in enumerate((24, 41, 57, 90))]


def phase_serve_head_dim(run: str, smi: str) -> dict:
    """A 2-layer Llama at a head dim the paged kernel refused before
    (`SERVE_HEAD_DIMS[run]`: 32 heads of 72 over 8 KV heads, or 8 heads of
    320 over 8, the wide kernel), fp32 on random weights from a seed,
    served at temperature 0 by the port's Engine with its CUDA graphs at
    4 slots: through the default paged read (the kernel), then on the
    same weights through the gather read (`set_paged_attn`), as
    `phase_gather` does. The kernel run launches the paged kernel once
    a layer a forward and the gather run none; the gather streams equal
    the kernel's, or part from them only at a near tie. The model is
    freed."""
    from hyperion_tpu_torch.models.llama import (
        Llama,
        llama2_7b_config,
        set_paged_attn,
    )
    from hyperion_tpu_torch.ops.paged_attention import paged_attention
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.queue import Request

    t0 = time.perf_counter()
    cfg = llama2_7b_config(n_layers=2, max_len=256, dtype="float32",
                           norm_impl="pallas", **SERVE_HEAD_DIMS[run])
    model = Llama(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 90))
    reqs = serve_head_dim_requests(np.random.default_rng(SEED + 91))
    runs = {}
    for impl in ("pallas", "gather"):
        set_paged_attn(model, impl)
        eng = Engine(model, EngineConfig(slots=4, max_len=256),
                     device="cuda")
        eng.warmup([max(len(r["prompt_ids"]) for r in reqs)])
        rs = [Request(prompt_ids=np.asarray(r["prompt_ids"], np.int32),
                      max_new_tokens=r["max_new_tokens"], id=r["id"])
              for r in reqs]
        paged_attention.launches = 0
        eng.forwards = 0
        drive(eng, rs)
        torch.cuda.synchronize()
        runs[impl] = {"tokens": {r.id: r.tokens for r in rs},
                      "launches": paged_attention.launches,
                      "forwards": eng.forwards,
                      "graphs": len(eng.tier.graphs)}
        del eng
    set_paged_attn(model, "pallas")
    results = [near_tie_record(model, cfg, r["id"],
                               np.asarray(r["prompt_ids"]),
                               runs["gather"]["tokens"][r["id"]],
                               runs["pallas"]["tokens"][r["id"]])
               for r in reqs]
    want = runs["pallas"]["forwards"] * cfg.n_layers
    rec = {"phase": run, "nvidia_smi": smi, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "dtype": "float32", "requests": len(reqs), "streams": results,
           "tokens": sum(len(t) for t in runs["pallas"]["tokens"].values()),
           "launches": {"paged_attention": runs["pallas"]["launches"]},
           "launches_expected": {"paged_attention": want},
           "gather_launches": runs["gather"]["launches"],
           **{f"{impl}_{k}": v for impl, r in runs.items()
              for k, v in r.items() if k != "tokens"}}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    emit(rec)
    problems = []
    if rec["launches"] != rec["launches_expected"] or \
            rec["gather_launches"]:
        problems.append(f"paged launches: kernel {rec['launches']} (want "
                        f"{want}), gather {rec['gather_launches']}")
    if not runs["pallas"]["graphs"]:
        problems.append("no CUDA graph captured")
    if rec["tokens"] != 16 * len(reqs):
        problems.append(f"{rec['tokens']} tokens")
    if beyond_near_tie(results):
        problems.append(f"streams {beyond_near_tie(results)}")
    if problems:
        raise AssertionError(f"{run}: " + "; ".join(problems))
    return rec

def _launch_counts() -> dict:
    """Every training-path kernel's launch count (the wrappers' own)."""
    from hyperion_tpu_torch.ops import flash_attention as fa
    from hyperion_tpu_torch.ops import fused_ce, fused_norm

    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_dq": fa.flash_attention_dq.launches,
            "flash_attention_dkv": fa.flash_attention_dkv.launches,
            "fused_rmsnorm": fused_norm.fused_rmsnorm.launches,
            "fused_rmsnorm_bwd": fused_norm.fused_rmsnorm_bwd.launches,
            "fused_softmax_xent_fwd":
                fused_ce.fused_softmax_xent_fwd.launches,
            "fused_softmax_xent_bwd":
                fused_ce.fused_softmax_xent_bwd.launches}


def _reset_launch_counts() -> None:
    from hyperion_tpu_torch.ops import flash_attention as fa
    from hyperion_tpu_torch.ops import fused_ce, fused_norm

    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv, fused_norm.fused_rmsnorm,
               fused_norm.fused_rmsnorm_bwd, fused_ce.fused_softmax_xent_fwd,
               fused_ce.fused_softmax_xent_bwd):
        fn.launches = 0


def llama_launches_expected(n_layers: int, steps: int, evals: int) -> dict:
    """Launches of one LoRA fine-tune under remat "full": each train step
    runs every block's forward twice (once more inside the backward's
    recompute, where the flash forward and both norms launch again; the
    final norm is outside remat), then dq and dk/dv once per layer and
    the RMSNorm backward kernel once per norm whose input needs a
    gradient: every norm but the first, which takes the frozen
    embedding's output; an eval batch runs the forward once."""
    return {"flash_attention_fwd": n_layers * (2 * steps + evals),
            "flash_attention_dq": n_layers * steps,
            "flash_attention_dkv": n_layers * steps,
            "fused_rmsnorm": (2 * n_layers + 1) * (steps + evals)
            + 2 * n_layers * steps,
            "fused_rmsnorm_bwd": 2 * n_layers * steps,
            "fused_softmax_xent_fwd": steps + evals,
            "fused_softmax_xent_bwd": steps}


def phase_llama_train_model() -> None:
    """A tiny fp32 Llama with LoRA (q/k/v/o, B drawn nonzero so every
    factor has a gradient), GQA, remat "full", attention and norm at
    "pallas", on the CPU (plain versions) and on the card (kernels) with
    the same weights, a ragged 48-token window and a padding mask: the
    loss and every adapter gradient within 2e-5 + 2e-5 relative, and
    the card's launches exact."""
    from hyperion_tpu_torch.models.llama import Llama, llama_tiny_config
    from hyperion_tpu_torch.train.losses import next_token_loss

    cfg = llama_tiny_config(d_model=128, n_heads=4, n_kv_heads=2, max_len=64,
                            lora_rank=4, lora_scale=2.0, remat="full",
                            attention_impl="pallas", norm_impl="pallas")
    cpu = Llama(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 24)
    for ab in cpu.lora_params().values():
        for p in ab.values():
            p.data.normal_(0.0, 0.05, generator=gen)
    gpu = Llama(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(SEED + 25)
    B, T = 2, 48
    ids = torch.as_tensor(rng.integers(1, 256, (B, T)), dtype=torch.int32)
    mask = torch.as_tensor(np.arange(T)[None] < np.array([T, 37])[:, None],
                           dtype=torch.int8)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        if dev == "cuda":
            _reset_launch_counts()
        logits = model(ids.to(dev), padding_mask=mask.to(dev))
        loss = next_token_loss(logits, ids.to(dev), mask.to(dev),
                               impl="pallas")
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = _launch_counts()
        out[dev] = (loss.detach().cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.requires_grad})
    errs = {"loss": float((out["cpu"][0] - out["cuda"][0]).abs()),
            "adapter_grads": max(float((a - out["cuda"][1][n]).abs().max())
                                 for n, a in out["cpu"][1].items())}
    ok = (torch.allclose(out["cpu"][0], out["cuda"][0], atol=2e-5, rtol=2e-5)
          and len(out["cpu"][1]) == 4 * 2 * cfg.n_layers
          and all(torch.allclose(a, out["cuda"][1][n], atol=2e-5, rtol=2e-5)
                  for n, a in out["cpu"][1].items()))
    expected = llama_launches_expected(cfg.n_layers, 1, 0)
    emit({"phase": "llama_train_model", "max_abs_err": errs, "tol": 2e-5,
          "launches": launched, "launches_expected": expected, "ok": ok})
    if not ok or launched != expected:
        raise AssertionError(f"llama_train_model: errors {errs}, launches "
                             f"{launched} != {expected}")


LLAMA_STEPS, LLAMA_EVALS = 8, 2


def llama_train_config(base: Path, steps: int = LLAMA_STEPS,
                       evals: int = LLAMA_EVALS, seq: int = 4096):
    """`train_llama` as the reference's Llama job runs it, cut to one
    card and a smoke's length: Llama-2-7B at its published widths and
    full depth, bf16, LoRA r 16 alpha 32 on q/k/v/o, remat "full",
    jit+pallas, seq 4096, batch 1 (the reference project's own), lr 1e-5,
    weight decay 0.01, clip 1.0; one epoch of `steps` steps on the seeded
    synthetic train split, and a 2-row seeded validation split written
    under `base` (emptied first)."""
    import shutil

    from hyperion_tpu_torch.config import Config
    from hyperion_tpu_torch.data.text import synthetic_lm_split

    shutil.rmtree(base, ignore_errors=True)
    data = base / "data" / "wikitext2_tokenized"
    data.mkdir(parents=True)
    val = synthetic_lm_split(evals, seq_len=seq, seed=SEED + 26)
    np.savez(data / "validation.npz", input_ids=val.input_ids,
             attention_mask=val.attention_mask)
    cfg = Config()
    t = cfg.train
    t.model, t.lora, t.lora_rank, t.lora_alpha = "llama_7b", True, 16, 32.0
    t.epochs, t.steps_per_epoch, t.batch_size, t.seq_len = 1, steps, 1, seq
    t.learning_rate, t.weight_decay = 1e-5, 0.01
    t.base_dir, t.data_dir = str(base), str(base / "data")
    o = cfg.optimization
    o.remat, o.compile_tier, o.grad_clip_norm = "full", "jit+pallas", 1.0
    return cfg


def phase_llama_train(smi: str) -> dict:
    """`train_llama` on the card at Llama-2-7B widths and depth (see
    `llama_train_config`): every loss finite and the first within
    [-0.1, +1.0] of ln 32000,
    the base bit-identical to its seeded init afterwards, every B factor
    moved off zero, one CSV row (mode lora_bf16), the adapter export
    reloads at the JAX adapter layout's shapes, and every kernel's
    launches exactly `llama_launches_expected`. Step time p50 (CUDA
    events), tokens/s and peak memory are smoke readings."""
    from hyperion_tpu_torch.checkpoint.io import load_gathered
    from hyperion_tpu_torch.models.llama import Llama
    from hyperion_tpu_torch.train.trainer import train_llama

    base = Path(__file__).resolve().parent / "build" / "chip_smoke_llama"
    cfg = llama_train_config(base)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = train_llama(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    model = res.model
    lcfg = model.cfg
    moved_b = all(bool(ab["b"].any()) for ab in model.lora_params().values())
    # the epoch-boundary checkpoint (the 7B base, the adapters and their
    # AdamW state) restored into the trained model: the walk-back's
    # deep verification and the load, timed
    from hyperion_tpu_torch.checkpoint import io as ckpt_io
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer

    template = TrainState(0, model, make_optimizer(model.parameters(), 1e-5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt_io.restore(base / "checkpoints" / "llama_1dev", template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_step = restored.step if restored is not None else None
    del template, restored
    # the base: bit-identical to a fresh model drawn from the same seed
    fresh = Llama(dataclasses.replace(lcfg, lora_rank=0), device="cuda")
    fresh.init_params(torch.Generator(device="cuda").manual_seed(
        cfg.train.seed))
    trained = dict(model.named_parameters())
    base_same = all(torch.equal(trained[n].float(), p.float())
                    for n, p in fresh.named_parameters())
    n_adapters = len(model.lora_params())
    del fresh, trained, model
    res.model = None
    gc.collect()
    torch.cuda.empty_cache()

    with open(res.csv_path) as f:
        rows = list(csv.reader(f))
    exported = load_gathered(base / "checkpoints" / "llama_lora_bf16_final.npz")
    q_ab = exported["layer_0"]["attn"]["q_proj"]["kernel"]
    o_ab = exported["layer_31"]["attn"]["o_proj"]["kernel"]
    losses = np.asarray(res.step_losses)
    step_ms = np.asarray(res.step_ms)
    p50 = float(np.percentile(step_ms, 50))
    rec = {
        "phase": "llama_train", "nvidia_smi": smi, "wall_s": wall,
        "layers": lcfg.n_layers, "d_model": lcfg.d_model,
        "seq_len": cfg.train.seq_len, "batch": cfg.train.batch_size,
        "steps": len(losses), "eval_batches": LLAMA_EVALS,
        "losses": losses.tolist(), "ln_vocab": math.log(lcfg.vocab_size),
        "val_loss": res.history[-1].extra.get("val_loss"),
        "step_ms": step_ms.tolist(), "step_ms_p50": p50,
        "tokens_per_s": cfg.train.seq_len * cfg.train.batch_size
        / (p50 / 1e3),
        "peak_mem_gb": peak / 1e9, "base_bit_identical": base_same,
        "adapters": n_adapters, "b_factors_moved": moved_b,
        "csv_header": rows[0], "csv_rows": len(rows) - 1,
        "export_shapes": {"q_a": list(q_ab["a"].shape),
                          "q_b": list(q_ab["b"].shape),
                          "o_a": list(o_ab["a"].shape),
                          "o_b": list(o_ab["b"].shape)},
        "launches": launches,
        "launches_expected": llama_launches_expected(
            lcfg.n_layers, len(losses), LLAMA_EVALS),
        "checkpoint": ckpt_readings(base, "llama_1dev")
        | {"restore_s": restore_s, "restored_step": restored_step},
        "gauges": gauge_readings(res),
    }
    emit(rec)
    problems = train_problems("llama_train", rec["checkpoint"],
                              rec["gauges"])
    if restored_step != LLAMA_STEPS:
        problems.append(f"7B checkpoint restored at {restored_step}")
    if len(losses) != LLAMA_STEPS or not np.isfinite(losses).all() \
            or not np.isfinite(rec["val_loss"]):
        problems.append(f"losses {losses.tolist()}, val {rec['val_loss']}")
    elif not -0.1 <= losses[0] - rec["ln_vocab"] <= 1.0:
        # seeded normal(0.02) weights give logits of std ~0.02 * sqrt(d)
        # = 1.28 after the final norm, which adds ~sigma^2 / 2 = 0.8
        # nats to ln V
        problems.append(f"first loss {losses[0]} not near ln V")
    if (lcfg.n_layers, lcfg.d_model, lcfg.n_heads, lcfg.ff_dim) != \
            (32, 4096, 32, 11008):
        problems.append("not Llama-2-7B's widths and depth")
    if not base_same:
        problems.append("the base weights moved")
    if not moved_b or n_adapters != 4 * 32:
        problems.append(f"adapters: {n_adapters}, B moved {moved_b}")
    if len(rows) != 2 or rows[1][rows[0].index("mode")] != "lora_bf16":
        problems.append(f"csv {rows}")
    if rec["export_shapes"] != {"q_a": [4096, 16], "q_b": [16, 32, 128],
                                "o_a": [32, 128, 16], "o_b": [16, 4096]}:
        problems.append(f"export shapes {rec['export_shapes']}")
    if launches != rec["launches_expected"]:
        problems.append(f"launch counts {launches} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("llama_train: " + "; ".join(problems))
    return rec


RESUME_DIR = Path("build/chip_smoke_resume")
# "[supervisor] child exit 4; doctor verdict: diverged (...)", and the
# serve and route supervisors' lines of the same form
VERDICT_LINE = re.compile(r"\[(?:supervisor|serve-supervisor|route-supervisor)"
                          r"\] (?:child|router) exit (-?\d+); doctor "
                          r"verdict: (\w+)")


def logged_verdicts(log: str) -> list[tuple[int, str]]:
    """(exit code, verdict) of every restart a supervisor logged."""
    return [(int(rc), v) for rc, v in VERDICT_LINE.findall(log)]


def obs_cli(*argv: str) -> dict:
    """`python -m hyperion_tpu_torch.cli.main obs ...` from the
    checkout's root (a host tool: it imports no torch)."""
    p = subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "obs", *argv],
        cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=120)
    return {"rc": p.returncode, "out": p.stdout, "err": p.stderr}


def doctor_check(target: Path, want: str | tuple, problems: list,
                 what: str, run: str | None = None,
                 now: float | None = None) -> dict:
    """The port's `diagnose` and its `obs doctor --json` CLI on one run
    dir (or one run of it): the same verdict, one of `want`, and the CLI
    the verdict's exit code (`EXIT_BY_VERDICT`)."""
    from hyperion_tpu_torch.obs.doctor import EXIT_BY_VERDICT, diagnose

    want = (want,) if isinstance(want, str) else want
    d = diagnose(target, run=run, now=now)
    cli = obs_cli("doctor", str(target), "--json",
                  *(["--run", run] if run else []),
                  *(["--now", repr(now)] if now is not None else []))
    try:
        cli_verdict = json.loads(cli["out"]).get("verdict")
    except json.JSONDecodeError:
        cli_verdict = None
    got = {"run": d.get("run"), "verdict": d["verdict"],
           "cli_verdict": cli_verdict, "cli_rc": cli["rc"],
           "attempt": d.get("attempt"), "last_step": d.get("last_step"),
           "fleet": [(r["replica"], r["state"]) for r in d.get("fleet") or []],
           "reason": d["reason"][:240]}
    if not (d["verdict"] in want and cli_verdict == d["verdict"]
            and cli["rc"] == EXIT_BY_VERDICT[d["verdict"]]):
        problems.append(f"{what}: doctor {got}, wanted {want}")
    return got


def stream_runs(tele: Path) -> list[tuple[str, float]]:
    """(run id, its last t_wall) of each run in a stream, in order."""
    last: dict[str, float] = {}
    for r in _records(tele):
        if r.get("run") and isinstance(r.get("t_wall"), (int, float)):
            last[r["run"]] = r["t_wall"]
    return list(last.items())


def resume_config(base: Path, *, epochs: int = 2, steps: int = 0,
                  batch: int = 32, chaos: str = "", prefetch: int = 2,
                  validate: bool = True):
    """language_ddp at its published widths (d 256, 4 heads, 2 layers,
    GPT-2 vocab, seq 128, batch 32, bf16 over fp32 masters, dropout 0.1,
    jit+pallas) on the committed real WikiText-2 splits: train on
    `test` (2891 rows, 90 steps an epoch), validate on `validation`
    (2461 rows, 76 batches), both read by the port's numpy arrow reader;
    health "warn", async checkpoints. `steps` caps an epoch (a CPU
    rehearsal); `base` is emptied first."""
    import shutil

    from hyperion_tpu_torch.config import Config

    shutil.rmtree(base, ignore_errors=True)
    cfg = Config()
    t = cfg.train
    t.epochs, t.steps_per_epoch, t.batch_size = epochs, steps, batch
    t.train_split, t.validate, t.chaos = "test", validate, chaos
    t.prefetch_depth = prefetch
    t.base_dir = str(base)
    t.data_dir = str(Path(__file__).resolve().parent / "data")
    cfg.optimization.compile_tier = "jit+pallas"
    assert (t.seq_len, cfg.optimization.precision, t.health_policy,
            t.async_checkpoint) == (128, "bf16", "warn", True)
    return cfg


def _resume_argv(base: Path, chaos: str, device: str, steps: int,
                 batch: int, *extra: str) -> list[str]:
    """A supervised `train` command over `resume_config`'s run."""
    argv = [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "train",
            "--model", "language_ddp", "--train-split", "test",
            "--epochs", "2", "--supervise", "--max-restarts", "2",
            "--chaos", chaos, "--base_dir", str(base), "--data_dir", "data",
            "--compile-tier", "jit+pallas", "--device", device,
            "--batch_size", str(batch), *extra]
    if steps:
        argv += ["--steps-per-epoch", str(steps)]
    return argv


def _supervised(argvs: list[list[str]], timeout_s: float) -> list[dict]:
    """Run supervised `train` commands from the checkout's root, all at
    once (each in its own base dir; the card holds them together);
    sample each supervising process's memory maps while it runs (it must
    map no CUDA library)."""
    import threading

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    runs = []
    for argv in argvs:
        proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        out: list[str] = []
        reader = threading.Thread(target=lambda p=proc, o=out: o.extend(
            p.stdout), daemon=True)
        reader.start()
        runs.append({"argv": argv, "proc": proc, "out": out,
                     "reader": reader, "samples": 0, "cuda": False,
                     "seconds": None})
    try:
        while any(r["proc"].poll() is None for r in runs):
            if time.perf_counter() - t0 > timeout_s:
                raise TimeoutError(f"{argvs} ran past {timeout_s} s")
            for r in runs:
                if r["proc"].poll() is None:
                    r["samples"] += 1
                    r["cuda"] |= _maps_cuda(r["proc"].pid)
                elif r["seconds"] is None:
                    r["seconds"] = time.perf_counter() - t0
            time.sleep(0.5)
    finally:
        for r in runs:
            if r["proc"].poll() is None:
                _reap_group(r["proc"].pid, grace_s=5.0)
            r["proc"].wait()
            r["reader"].join(timeout=10)
    return [{"rc": r["proc"].returncode,
             "seconds": r["seconds"] or time.perf_counter() - t0,
             "log": "".join(r["out"]), "maps_samples": r["samples"],
             "supervisor_maps_cuda": r["cuda"]} for r in runs]


def _export_equal(a: Path, b: Path) -> bool:
    from hyperion_tpu_torch.checkpoint.io import load_gathered

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    fa, fb = dict(flat(load_gathered(a))), dict(flat(load_gathered(b)))
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def _csv_rows(base: Path) -> list[list[str]]:
    """Every epoch row of every run's CSV under `base`, in epoch order."""
    rows = []
    for path in sorted((base / "distributed").glob("*_metrics.csv")):
        with open(path) as f:
            rows += list(csv.reader(f))[1:]
    return sorted(rows, key=lambda r: int(r[0]))


def phase_train_resume(smi: str, device: str = "cuda", steps: int = 0,
                       batch: int = 32) -> dict:
    """language_ddp on the real splits (`resume_config`), 2 epochs, in
    four legs. A: uninterrupted, in-process (its launch counts are the
    phase's main-path counts). B: `sigterm@step=S+30` latches the guard
    before epoch 2's batch 30; the loop saves a mid-epoch checkpoint and
    returns preempted; a second call resumes at (epoch 1, step 30). Its
    export and CSV loss column bit-identical to A's, and its CE and
    LayerNorm launches, summed over both calls, exactly A's. C: the
    supervised CLI with `kill@step=S+60`: one restart, the child adopts
    the epoch-1 save (written, no manifest) and retrains epoch 2; exit 0,
    export bit-identical to A's, the supervisor maps no CUDA library. D:
    `nan_loss@step=S+10` under `--health-policy abort`: the child exits
    4, the supervisor quarantines the newest checkpoint and restarts;
    the chaos record keeps the fault from firing again. C and D run at
    once, each in its own base dir. Then the step p50 and input wait at
    prefetch 2 and 0, in turns (p2, p0, p0, p2); then the port's `obs
    doctor` on every life of every leg and `obs diff` of two prefetch
    runs. S is the steps of an epoch (90 on the card; `steps` caps it for a
    CPU rehearsal, with `batch`)."""
    from hyperion_tpu_torch.ops.fused_ce import (
        fused_softmax_xent_bwd,
        fused_softmax_xent_fwd,
    )
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
    from hyperion_tpu_torch.train.trainer import train_language_model

    root = Path(__file__).resolve().parent / RESUME_DIR
    counted = (fused_layernorm, fused_softmax_xent_fwd,
               fused_softmax_xent_bwd)

    def launches() -> dict:
        return {f.__name__: f.launches for f in counted}

    def reset() -> None:
        for f in counted:
            f.launches = 0

    from hyperion_tpu_torch.data.text import load_wikitext2

    data = load_wikitext2(Path(__file__).resolve().parent / "data",
                          splits=("test", "validation"))
    splits = {k: {"rows": len(v), "source": v.source}
              for k, v in data.items()}
    del data

    # A: uninterrupted
    gc.collect()
    reset()
    a = train_language_model(resume_config(root / "a", steps=steps,
                                           batch=batch), device=device)
    a_launch = launches()
    S = len(a.step_losses) // 2
    evals = sum(r.get("batches", 0) for r in
                map(json.loads, (root / "a" / "telemetry.jsonl")
                    .read_text().splitlines()) if r.get("name") == "eval")
    a_export = root / "a" / "checkpoints" / "language_ddp_final.npz"
    a.model = None

    # B: graceful preemption, then an in-process resume
    reset()
    cfg = resume_config(root / "b", steps=steps, batch=batch,
                        chaos=f"sigterm@step={S + S // 3}")
    b1 = train_language_model(cfg, device=device)
    b1.model = None
    cfg.train.chaos = ""
    b2 = train_language_model(cfg, device=device)
    b2.model = None
    b_launch = launches()
    b_ckpt = ckpt_readings(root / "b", "language_ddp_1dev")
    b_export = root / "b" / "checkpoints" / "language_ddp_final.npz"

    # C: supervised crash; D: divergence under abort (together)
    c, d = _supervised([
        _resume_argv(root / "c", f"kill@step={S + 2 * S // 3}", device,
                     steps, batch),
        _resume_argv(root / "d", f"nan_loss@step={S + S // 9}", device,
                     steps, batch, "--health-policy", "abort")], 600)
    c_export = root / "c" / "checkpoints" / "language_ddp_final.npz"
    d_export = root / "d" / "checkpoints" / "language_ddp_final.npz"
    d_ckpts = root / "d" / "checkpoints" / "language_ddp_1dev"
    quarantined = sorted(p.name for p in d_ckpts.glob("*.corrupt*"))

    # prefetch 2 and 0, in turns: one epoch each, no validation
    turns = []
    for i, depth in enumerate((2, 0, 0, 2)):
        r = train_language_model(resume_config(
            root / f"prefetch_{i}", epochs=1, steps=steps, batch=batch,
            prefetch=depth, validate=False), device=device)
        r.model = None
        turns.append({"prefetch": depth,
                      "step_ms_p50": float(np.percentile(r.step_ms, 50))
                      if r.step_ms else None,
                      "input_wait_frac":
                          r.metrics["gauges"].get("input_wait_frac"),
                      "epoch_s": r.history[-1].duration_s})

    def lines(log: str, *keys: str) -> list[str]:
        return [x for x in log.splitlines() if any(k in x for k in keys)]

    # the port's doctor on every life of every leg: A and B's runs and
    # C and D's last lives healthy; C's killed life and D's NaN life
    # the verdicts their supervisor logged (the doctor at that life's
    # last record, as the supervisor consulted it)
    doc_problems: list[str] = []
    doc = {"a": doctor_check(root / "a", "healthy", doc_problems, "A"),
           "b": [doctor_check(root / "b", "healthy", doc_problems,
                              f"B run {i}", run=r.run_id)
                 for i, r in enumerate((b1, b2))]}
    for leg, res, dead_want in (("c", c, ("running", "crashed")),
                                ("d", d, ("diverged",))):
        logged = logged_verdicts(res["log"])
        runs = stream_runs(root / leg / "telemetry.jsonl")
        doc[leg] = {"logged": logged, "lives": [
            doctor_check(root / leg, dead_want, doc_problems,
                         f"{leg.upper()} life {i}", run=run, now=t + 1.0)
            for i, (run, t) in enumerate(runs[:-1])]}
        doc[leg]["lives"].append(doctor_check(
            root / leg, "healthy", doc_problems, f"{leg.upper()} last life"))
        if len(logged) != len(runs) - 1 or not all(
                v in dead_want for _, v in logged):
            doc_problems.append(f"{leg.upper()}: the supervisor logged "
                                f"{logged} for {len(runs)} lives, wanted "
                                f"{dead_want}")
    if doc["d"]["logged"][:1] != [(4, "diverged")]:
        doc_problems.append(f"D: logged {doc['d']['logged']}")
    diff = obs_cli("diff", str(root / "prefetch_0"), str(root / "prefetch_1"))
    doc["diff"] = {"rc": diff["rc"], "table": [
        x for x in diff["out"].splitlines() if x.startswith("| ")]}
    if diff["rc"] not in (0, 1) or not doc["diff"]["table"]:
        doc_problems.append(f"obs diff of two prefetch runs: exit "
                            f"{diff['rc']}: {diff['err'][-500:]}")

    rec = {
        "phase": "train_resume", "nvidia_smi": smi,
        "steps_per_epoch": S, "eval_batches": evals,
        "splits": splits, "pyarrow_imported": "pyarrow" in sys.modules,
        "losses": [{"epoch": h.epoch, "train_loss": h.loss,
                    "val_loss": h.extra.get("val_loss")}
                   for h in a.history],
        "gauges": gauge_readings(a),
        "checkpoint": ckpt_readings(root / "a", "language_ddp_1dev"),
        "restore_s": b_ckpt["restore_s"],
        "launches": a_launch,
        "launches_expected": {
            "fused_layernorm": 5 * (2 * S + evals),
            "fused_softmax_xent_fwd": 2 * S + evals,
            "fused_softmax_xent_bwd": 2 * S},
        "b": {"first_preempted": b1.preempted, "first_steps":
              len(b1.step_losses), "resumed_steps": len(b2.step_losses),
              "launches": b_launch,
              "export_equal": _export_equal(a_export, b_export),
              "csv_loss_equal": [r[1] for r in _csv_rows(root / "b")]
              == [r[1] for r in _csv_rows(root / "a")]},
        "c": {"rc": c["rc"], "seconds": c["seconds"],
              "supervisor_maps_cuda": c["supervisor_maps_cuda"],
              "maps_samples": c["maps_samples"],
              "export_equal": c_export.exists()
              and _export_equal(a_export, c_export),
              "log": lines(c["log"], "[supervisor]", "[chaos]", "adopted",
                           "resumed", "epoch ")},
        "d": {"rc": d["rc"], "seconds": d["seconds"],
              "quarantined": quarantined,
              "export_equal": d_export.exists()
              and _export_equal(a_export, d_export),
              "log": lines(d["log"], "[supervisor]", "[chaos]", "health",
                           "resumed", "quarantined", "epoch ")},
        "prefetch_turns": turns,
        "doctor": doc,
    }
    emit(rec)
    problems = list(doc_problems)
    if rec["pyarrow_imported"] or [v["rows"] for v in splits.values()] \
            != [2891, 2461] or not all(v["source"].startswith("arrow:")
                                       for v in splits.values()):
        problems.append(f"splits {splits}, pyarrow imported "
                        f"{rec['pyarrow_imported']}")
    if not (a.history and len(a.history) == 2 and S > 0
            and all(np.isfinite([h.loss, h.extra.get("val_loss")]).all()
                    for h in a.history)):
        problems.append(f"A: {rec['losses']}")
    if a_launch != rec["launches_expected"]:
        problems.append(f"A launches {a_launch}")
    if not (b1.preempted is True and b2.preempted is False
            and len(b1.step_losses) == S + S // 3
            and len(b1.step_losses) + len(b2.step_losses) == 2 * S):
        problems.append(f"B: {rec['b']}")
    if b_launch != a_launch or not rec["b"]["export_equal"] \
            or not rec["b"]["csv_loss_equal"]:
        problems.append(f"B against A: {rec['b']}")
    c_log = c["log"]
    if not (c["rc"] == 0 and rec["c"]["export_equal"]
            and not c["supervisor_maps_cuda"] and c["maps_samples"]
            and "attempt 1:" in c_log and "attempt 2:" not in c_log
            and f"adopted step_{S:08d}" in c_log
            and f"resumed from step {S} " in c_log):
        problems.append(f"C: {rec['c']}")
    d_log = d["log"]
    if not (d["rc"] == 0 and "child exit 4" in d_log
            and f"step_{S:08d}.corrupt" in quarantined
            and "attempt 1:" in d_log and "attempt 2:" not in d_log
            and d_log.count("[chaos] firing") == 1
            and rec["d"]["export_equal"]):
        problems.append(f"D: {rec['d']}")
    if problems:
        raise AssertionError("train_resume: " + "; ".join(problems))
    return rec


def phase_model() -> None:
    from hyperion_tpu_torch.models.llama import (
        Llama,
        init_paged_cache,
        llama_tiny_config,
    )

    # the JAX tiny config's widths (d 64, 4 heads: head_dim 16), GQA rep 2
    cfg = llama_tiny_config(n_kv_heads=2, max_len=64, norm_impl="pallas")
    cpu = Llama(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    gpu = Llama(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    bs, S, MB = 4, 2, 16
    bt = torch.as_tensor(np.random.default_rng(SEED).permutation(
        np.arange(1, S * MB + 1)).reshape(S, MB).astype(np.int32))
    caches = {"cpu": init_paged_cache(cfg, S * MB + 1, bs, device="cpu"),
              "cuda": init_paged_cache(cfg, S * MB + 1, bs, device="cuda")}
    rng = np.random.default_rng(SEED + 1)
    steps = [  # (name, ids, cache_index, rows)
        ("prefill_S8", rng.integers(1, 250, (S, 8)), 0, [0, 1]),
        ("chunk_1x8_start8", rng.integers(1, 250, (1, 8)), 8, [0]),
        ("verify_Sx4", rng.integers(1, 250, (S, 4)),
         np.array([16, 8], np.int32), [0, 1]),
        ("decode_Sx1", rng.integers(1, 250, (S, 1)),
         np.array([20, 12], np.int32), [0, 1]),
    ]
    worst = 0.0
    for name, ids, idx, rows in steps:
        out = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            ci = torch.as_tensor(idx) if isinstance(idx, np.ndarray) else idx
            logits, _ = model(torch.as_tensor(ids), cache=caches[dev],
                              cache_index=ci, block_tables=bt[rows])
            out[dev] = logits.cpu()
        err = float((out["cpu"] - out["cuda"]).abs().max())
        worst = max(worst, err)
        if not torch.allclose(out["cpu"], out["cuda"], atol=2e-5, rtol=2e-5):
            raise AssertionError(f"model {name}: logits differ by {err}")
    for layer_c, layer_g in zip(caches["cpu"], caches["cuda"]):
        for kv in ("k", "v"):
            if not torch.allclose(layer_c[kv], layer_g[kv].cpu(),
                                  atol=2e-5, rtol=2e-5):
                raise AssertionError("model: K/V pools differ")
    emit({"phase": "model", "steps": [s[0] for s in steps],
          "max_abs_err": worst, "tol": 2e-5, "ok": True})


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def near_tie_record(model, cfg, rid, prompt, got, ref) -> dict:
    """`got` against the reference stream `ref`: equal, or where they part
    the reference's top-2 logit margin there (a near tie lets another
    rounding of the same sums pick the other token)."""
    from hyperion_tpu_torch.models.llama import init_cache

    i = first_divergence(got, ref)
    rec = {"id": rid, "equal": i is None and len(got) == len(ref)}
    if i is not None:
        ids = np.concatenate([prompt, np.asarray(ref[:i])])[None]
        logits, _ = model(torch.as_tensor(ids), cache=init_cache(
            cfg, 1, ids.shape[1], device="cuda"), cache_index=0)
        top2 = torch.topk(logits[0, -1], 2).values
        rec.update(first_divergence=i, top2_margin=float(top2[0] - top2[1]))
    return rec


def beyond_near_tie(results: list[dict]) -> list[dict]:
    """Unequal streams not explained by a near tie (a stream that ends
    short of the reference has no margin: it always counts)."""
    return [r for r in results if not r["equal"]
            and r.get("top2_margin", math.inf) > 1e-3]


def drive(eng, reqs) -> None:
    for r in reqs:
        ok, why = eng.submit(r)
        assert ok, why
    while not eng.idle:
        eng.step()


def oracle_feature_requests(rng) -> list[list]:
    """Three waves through the feature engine: (1) an 80-token shared
    prefix (5 full blocks) with a tail, two prompts of one token
    repeated (a random-weight model then emits runs of one token, where
    n-gram drafts hit), a 150-token prompt (chunks of 64); (2) three
    120-token prompts whose blocks overflow the 23-block pool, so the
    radix evicts wave 1's chains to the host; (3) the shared prefix
    again, restored from the host."""
    from hyperion_tpu_torch.serve.queue import Request

    def req(ids, rid, n=16):
        return Request(prompt_ids=np.asarray(ids, np.int32),
                       max_new_tokens=n, id=rid)

    shared = rng.integers(1, 32000, 80)
    wave1 = [req(np.concatenate([shared, rng.integers(1, 32000, 30)]), "f0"),
             req(np.full(60, rng.integers(1, 32000)), "f1", 32),
             req(np.full(40, rng.integers(1, 32000)), "f2", 32),
             req(rng.integers(1, 32000, 150), "f3")]
    wave2 = [req(rng.integers(1, 32000, 120), f"f{4 + i}") for i in range(3)]
    wave3 = [req(np.concatenate([shared, rng.integers(1, 32000, 20)]), "f7")]
    return [wave1, wave2, wave3]


def phase_oracle() -> None:
    """Llama-2-7B widths at 2 layers, fp32, against the port's `generate`
    under the near-tie rule: the default engine; the feature engine
    (spec_k 4 with n-gram drafts, 64-token chunks, a pool small enough
    that the radix evicts and a host tier that holds what it evicts),
    whose spills, restores, chunk segments and accepted drafts must each
    happen; and `generate_speculative` with a 1-layer draft."""
    from hyperion_tpu_torch.infer.generate import generate
    from hyperion_tpu_torch.infer.speculative import generate_speculative
    from hyperion_tpu_torch.models.llama import Llama, llama2_7b_config
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.queue import Request

    cfg = llama2_7b_config(n_layers=2, max_len=256, dtype="float32",
                           norm_impl="pallas")
    model = Llama(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(SEED))

    def ref(prompt, n=16):
        return generate(model, prompt[None], n, device="cuda")[0].tolist()

    eng = Engine(model, EngineConfig(slots=3, max_len=256, block_size=16),
                 device="cuda")
    eng.warmup([100])
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(1, 32000, 40)
    prompts = [np.concatenate([shared, rng.integers(1, 32000, 30)]),
               np.concatenate([shared, rng.integers(1, 32000, 50)]),
               rng.integers(1, 32000, 24), rng.integers(1, 32000, 90)]
    reqs = [Request(prompt_ids=p.astype(np.int32), max_new_tokens=16,
                    id=f"o{i}") for i, p in enumerate(prompts)]
    drive(eng, reqs)
    results = [near_tie_record(model, cfg, r.id, r.prompt_ids, r.tokens,
                               ref(r.prompt_ids)) for r in reqs]
    prefix_hits = eng.metrics.summary()["prefix_hits"]
    del eng

    feat = Engine(model, EngineConfig(
        slots=3, max_len=256, block_size=16, num_blocks=24, spec_k=4,
        draft="ngram", prefill_chunk=64, host_cache_mb=256), device="cuda")
    feat.warmup([150])
    feat_reqs = []
    for wave in oracle_feature_requests(rng):
        drive(feat, wave)
        feat_reqs += wave
    feat_results = [near_tie_record(model, cfg, r.id, r.prompt_ids,
                                    r.tokens,
                                    ref(r.prompt_ids, r.max_new_tokens))
                    for r in feat_reqs]
    s = feat.metrics.summary()
    counts = {"host_spilled_blocks": s["host_spilled_blocks"],
              "host_restored_blocks": s["host_restored_blocks"],
              "chunk_segments": feat.chunk_segments,
              "spec_accepted": s["spec_accepted"]}
    del feat

    draft = Llama(llama2_7b_config(n_layers=1, max_len=256,
                                   dtype="float32", norm_impl="pallas"),
                  device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 1))
    spec_results = []
    for i, p in enumerate((feat_reqs[0].prompt_ids, feat_reqs[1].prompt_ids,
                           prompts[3])):
        out = generate_speculative(model, draft, p[None], 16, k=4,
                                   device="cuda")[0].tolist()
        spec_results.append(near_tie_record(model, cfg, f"g{i}", p, out,
                                            ref(p)))
    emit({"phase": "oracle", "layers": cfg.n_layers, "requests": results,
          "prefix_hits": prefix_hits, "feature_requests": feat_results,
          "feature_counts": counts,
          "generate_speculative": spec_results})
    problems = []
    for what, res in (("engine", results), ("feature engine", feat_results),
                      ("generate_speculative", spec_results)):
        if beyond_near_tie(res):
            problems.append(f"{what} streams diverge from generate beyond "
                            f"a near-tie: {beyond_near_tie(res)}")
    problems += [f"feature engine: no {k}" for k, v in counts.items()
                 if v < 1]
    if problems:
        raise AssertionError("oracle: " + "; ".join(problems))


def serve_requests(rng) -> list[dict]:
    """8 requests, prompts of 32..500 tokens: three share a 200-token
    prefix and diverge mid-block (200 = 12.5 blocks of 16), six greedy
    and two sampled with seeds."""
    shared = rng.integers(1, 32000, 200)
    prompts = [
        np.concatenate([shared, rng.integers(1, 32000, 40)]),    # 240
        rng.integers(1, 32000, 500),
        rng.integers(1, 32000, 32),
        np.concatenate([shared, rng.integers(1, 32000, 100)]),   # 300
        rng.integers(1, 32000, 120),
        np.concatenate([shared, rng.integers(1, 32000, 60)]),    # 260
        rng.integers(1, 32000, 64),
        rng.integers(1, 32000, 350),
    ]
    reqs = []
    for i, p in enumerate(prompts):
        r = {"id": f"s{i}", "prompt_ids": p.astype(int).tolist(),
             "max_new_tokens": 32}
        if i in (2, 6):
            r.update(temperature=0.8, top_p=0.9, seed=100 + i)
        reqs.append(r)
    return reqs


def phase_serve() -> tuple[dict, torch.nn.Module, list[dict], dict]:
    """Returns the record, the model (for serve_features), the requests
    and their token streams."""
    from hyperion_tpu_torch.models.llama import Llama, llama2_7b_config
    from hyperion_tpu_torch.ops.fused_norm import fused_rmsnorm
    from hyperion_tpu_torch.ops.paged_attention import paged_attention
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.server import serve_jsonl

    t0 = time.perf_counter()
    cfg = llama2_7b_config(dtype="bfloat16", norm_impl="pallas")
    n_layers = cfg.n_layers
    model = Llama(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(model, EngineConfig(slots=4, max_len=1024, block_size=16),
                 device="cuda")
    stats = eng.warmup([500])
    reqs = serve_requests(np.random.default_rng(SEED + 3))
    infile = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    outfile = io.StringIO()

    gc.collect()  # earlier phases' garbage stays out of the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated()
    paged_attention.launches = 0
    fused_rmsnorm.launches = 0
    eng.forwards = 0
    t0 = time.perf_counter()
    summary = serve_jsonl(eng, infile, outfile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "fused_rmsnorm": fused_rmsnorm.launches}
    fwd = eng.forwards
    tick_s = eng.metrics.reg.histogram("serve_tick_ms").total / 1e3

    lines = [json.loads(x) for x in outfile.getvalue().splitlines()]
    done = {x["id"]: x for x in lines if x.get("event") == "done"}
    toks: dict[str, list[int]] = {}
    for x in lines:
        if x.get("event") == "token":
            toks.setdefault(x["id"], []).append(x["token"])
    rec = {
        "phase": "serve", "layers": n_layers,
        "params_b": round(sum(p.numel() for p in model.parameters()) / 1e9,
                          3),
        "weights_init_s": round(init_s, 3), "serve_wall_s": wall,
        "requests": len(reqs), "done": len(done),
        "prompt_tokens": sum(len(r["prompt_ids"]) for r in reqs),
        "tokens": summary["tokens"],
        "tokens_per_s": summary["tokens"] / wall,
        # the window splits into decode ticks and the rest: prefills,
        # admission and the front end
        "tick_s": tick_s, "outside_ticks_s": wall - tick_s,
        "prefills": fwd - summary["ticks"],
        "ttft_ms_p50": summary["ttft_ms"].get("p50"),
        "tpot_ms_p50": summary["tpot_ms"].get("p50"),
        "tick_ms_p50": eng.metrics.reg.histogram("serve_tick_ms")
        .percentile(50),
        "ticks": summary["ticks"], "forwards": fwd,
        "prefix_hits": summary["prefix_hits"],
        "cow_copies": summary["cow_copies"],
        "mem_at_start_gb": mem_at_start / 1e9,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_expected": {"paged_attention": fwd * n_layers,
                              "fused_rmsnorm": fwd * (2 * n_layers + 1)},
        **graph_record(eng, stats),
    }
    problems = graph_problems(eng, stats)
    rec["graph_vs_eager"] = graph_vs_eager(eng)
    rec["profiler_window"] = profiler_window(
        eng, np.random.default_rng(SEED + 8))
    emit(rec)
    problems += rec["graph_vs_eager"]["problems"] \
        + rec["profiler_window"]["problems"]
    for r in reqs:
        n = len(toks.get(r["id"], []))
        if r["id"] not in done or n != 32:
            problems.append(f"{r['id']}: done={r['id'] in done} tokens={n}")
        elif not all(0 <= t < cfg.vocab_size for t in toks[r["id"]]):
            problems.append(f"{r['id']}: token out of range")
    if summary["prefix_hits"] < 1:
        problems.append("no prefix hit")
    if summary["cow_copies"] < 1:
        problems.append("no COW copy")
    if launches != rec["launches_expected"]:
        problems.append(f"launch counts {launches} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("serve: " + "; ".join(problems))
    return rec, model, reqs, toks


def serve_feature_waves(serve_reqs: list[dict], rng) -> list[list[dict]]:
    """Three waves through `serve_jsonl`: (1) the serve phase's eight
    (the 500- and 350-token prompts chunk at 256) and two prompts of one
    token repeated, 288 tokens (chunked) and 48 (a random-weight model
    then emits runs of one token, where n-gram drafts hit); (2) four
    600-token prompts, 40 blocks each with their budget, that overflow
    the 95-block pool, so the radix evicts wave 1's chains — the shared
    200-token prefix among them — to the host; (3) that prefix with a
    new 50-token tail, restored from the host."""
    def req(rid, ids):
        return {"id": rid, "prompt_ids": np.asarray(ids).astype(int).tolist(),
                "max_new_tokens": 32}

    shared = serve_reqs[0]["prompt_ids"][:200]
    wave1 = [dict(r) for r in serve_reqs] + [
        req(f"t{i}", np.full(n, rng.integers(1, 32000)))
        for i, n in enumerate((288, 48))]
    wave2 = [req(f"p{i}", rng.integers(1, 32000, 600)) for i in range(4)]
    wave3 = [req("rehit", np.concatenate(
        [shared, rng.integers(1, 32000, 50)]))]
    return [wave1, wave2, wave3]


def phase_serve_features(model, serve_reqs: list[dict], serve_toks: dict,
                         smi: str) -> dict:
    """Full Llama-2-7B (the serve phase's model) through `serve_jsonl` on
    the deferred decode paths at once: spec_k 4 with n-gram drafts,
    256-token chunks, a 96-block pool that forces radix eviction and a
    2 GiB host tier that holds what it evicts."""
    from hyperion_tpu_torch.ops.fused_norm import fused_rmsnorm
    from hyperion_tpu_torch.ops.paged_attention import paged_attention
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.server import serve_jsonl

    n_layers = model.cfg.n_layers
    eng = Engine(model, EngineConfig(
        slots=4, max_len=1024, block_size=16, spec_k=4, draft="ngram",
        prefill_chunk=256, num_blocks=96, host_cache_mb=2048),
        device="cuda")
    stats = eng.warmup([600])
    waves = serve_feature_waves(serve_reqs,
                                np.random.default_rng(SEED + 7))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    fused_rmsnorm.launches = 0
    eng.forwards = eng.chunk_segments = 0
    lines = []
    t0 = time.perf_counter()
    for wave in waves:
        outfile = io.StringIO()
        summary = serve_jsonl(
            eng, io.StringIO("".join(json.dumps(r) + "\n" for r in wave)),
            outfile)
        lines += [json.loads(x) for x in outfile.getvalue().splitlines()]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "fused_rmsnorm": fused_rmsnorm.launches}
    fwd = eng.forwards
    done = {x["id"] for x in lines if x.get("event") == "done"}
    toks: dict[str, list[int]] = {}
    for x in lines:
        if x.get("event") == "token":
            toks.setdefault(x["id"], []).append(x["token"])
    # the bf16 greedy streams against the plain serve phase's: where
    # they part, the serve stream's top-2 margin there (another GEMM
    # shape rounds the same sums differently)
    greedy = [near_tie_record(model, model.cfg, r["id"],
                              np.asarray(r["prompt_ids"]),
                              toks.get(r["id"], []), serve_toks[r["id"]])
              for r in serve_reqs if "temperature" not in r]
    reg = eng.metrics.reg
    rec = {
        "phase": "serve_features", "nvidia_smi": smi, "layers": n_layers,
        "requests": sum(len(w) for w in waves), "done": len(done),
        "serve_wall_s": wall, "tokens": summary["tokens"],
        "ticks": summary["ticks"], "forwards": fwd,
        "chunk_segments": eng.chunk_segments,
        "tick_ms_p50": reg.histogram("serve_tick_ms").percentile(50),
        "tokens_per_tick": summary["tokens_per_tick"],
        "spec_drafted": summary["spec_drafted"],
        "spec_accepted": summary["spec_accepted"],
        "accept_rate": summary["accept_rate"],
        "ttft_ms_p50": summary["ttft_ms"].get("p50"),
        "tpot_ms_p50": summary["tpot_ms"].get("p50"),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "blocks_evicted": summary["blocks_evicted"],
        "host_spilled_blocks": summary["host_spilled_blocks"],
        "host_restored_blocks": summary["host_restored_blocks"],
        "spill_bytes": int(reg.counter("serve_spill_bytes").value),
        "restore_bytes": summary["restore_bytes"],
        "tier_hits_host": summary["tier_hits_host"],
        "prefix_hits": summary["prefix_hits"],
        "greedy_equal_to_serve": sum(g["equal"] for g in greedy),
        "greedy_vs_serve": greedy,
        "launches": launches,
        "launches_expected": {"paged_attention": fwd * n_layers,
                              "fused_rmsnorm": fwd * (2 * n_layers + 1)},
        **graph_record(eng, stats),
    }
    emit(rec)
    problems = graph_problems(eng, stats)
    for r in (r for w in waves for r in w):
        got = toks.get(r["id"], [])
        if r["id"] not in done or len(got) != 32:
            problems.append(f"{r['id']}: done={r['id'] in done} "
                            f"tokens={len(got)}")
        elif not all(0 <= t < model.cfg.vocab_size for t in got):
            problems.append(f"{r['id']}: token out of range")
    for key in ("chunk_segments", "spec_accepted", "host_spilled_blocks",
                "host_restored_blocks"):
        if rec[key] < 1:
            problems.append(f"no {key}")
    if launches != rec["launches_expected"]:
        problems.append(f"launch counts {launches} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("serve_features: " + "; ".join(problems))
    return rec


LOAD_SPEC = dict(n_requests=48, rate_hz=8.0, prompt_lens=(32, 64, 128, 256),
                 max_new=(16, 32), vocab=32000, shared_prefix_tokens=200,
                 batch_every=4, temperature=0.0, seed=SEED + 20)


def phase_load(model, smi: str, device: str = "cuda") -> dict:
    """Full Llama-2-7B (the serve phase's model) under the load
    generator's seeded Poisson traffic (`run_load`, closed loop with a
    fresh 4-slot engine): every request done, no reject at queue capacity
    64, exactly the serving report's keys, prefix hits, no recompile and
    the kernels' launches exactly forwards x layers. Its readings are
    smoke readings, not a benchmark cell. `device` is for rehearsing the
    flow on the CPU with a tiny model."""
    from hyperion_tpu_torch.ops.fused_norm import fused_rmsnorm
    from hyperion_tpu_torch.ops.paged_attention import paged_attention
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.loadgen import (
        SERVING_REPORT_KEYS,
        LoadSpec,
        run_load,
    )

    t0 = time.perf_counter()
    n_layers = model.cfg.n_layers
    spec = LoadSpec(**LOAD_SPEC)
    eng = Engine(model, EngineConfig(slots=4, max_len=1024, block_size=16,
                                     queue_capacity=64), device=device)
    # every prefill bucket the spec reaches: the shared prefix plus the
    # longest tail
    stats = eng.warmup([spec.shared_prefix_tokens + max(spec.prompt_lens)])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    fused_rmsnorm.launches = 0
    eng.forwards = 0
    report = run_load(eng, spec)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "fused_rmsnorm": fused_rmsnorm.launches}
    fwd = eng.forwards
    rec = {
        "phase": "load", "nvidia_smi": smi, "layers": n_layers,
        "spec": LOAD_SPEC, "forwards": fwd,
        **{k: report[k] for k in (
            "requests", "completed", "rejected", "timed_out", "tokens",
            "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "e2e_p50_ms",
            "e2e_p99_ms", "elapsed_s", "prefix_hit_rate",
            "prefill_tokens_saved", "interactive_ttft_p99_ms",
            "batch_ttft_p99_ms", "interactive_completed",
            "batch_completed", "dominant_phase_p99", "recompiles")},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_expected": {"paged_attention": fwd * n_layers,
                              "fused_rmsnorm": fwd * (2 * n_layers + 1)},
        "report_keys_exact": set(report) == set(SERVING_REPORT_KEYS),
        **graph_record(eng, stats),
        "seconds": time.perf_counter() - t0,
    }
    emit(rec)
    problems = graph_problems(eng, stats)
    if report["completed"] != spec.n_requests or report["rejected"] \
            or report["timed_out"]:
        problems.append(f"completed {report['completed']}, rejected "
                        f"{report['rejected']}, timed out "
                        f"{report['timed_out']} of {spec.n_requests}")
    if not rec["report_keys_exact"]:
        problems.append("report keys differ by "
                        f"{sorted(set(report) ^ set(SERVING_REPORT_KEYS))}")
    if not report["prefix_hit_rate"]:
        problems.append("no prefix hit")
    if report["recompiles"]:
        problems.append(f"{report['recompiles']} recompiles")
    if launches != rec["launches_expected"]:
        problems.append(f"launch counts {launches} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("load: " + "; ".join(problems))
    return rec


def graph_record(eng, stats: dict) -> dict:
    """The compile tier after a run: graphs per surface (`compile_stats`,
    the JAX engine's keys), each graph's build seconds, recompiles, the
    graphs' shared pool."""
    return {"compile_stats": eng.compile_stats(), "warmup_stats": stats,
            "capture_s": eng.tier.capture_seconds(),
            "warmup_compile_s": eng.ledger.warmup["compile_s"],
            "recompiles": eng.ledger.recompiles,
            "graph_pool_bytes": eng.tier.pool_bytes()}


def graph_problems(eng, stats: dict) -> list[str]:
    problems = []
    if not eng.tier.graphs:
        problems.append("no CUDA graph captured")
    if eng.ledger.recompiles or eng.compile_stats() != stats:
        problems.append(f"recompiles {eng.ledger.recompiles}: "
                        f"{eng.compile_stats()} != {stats}")
    return problems


def graph_vs_eager(eng) -> dict:
    """One replay of the captured tick against the model's eager forward
    on the same inputs over a copy of the pools: logits bit-identical, or
    else within 2 ulps of the largest logit in the compute dtype (cuBLAS
    may pick another algorithm under capture), the greedy tokens equal,
    and the same K/V written."""
    rng = np.random.default_rng(SEED + 9)
    S, MB = eng.cfg.slots, eng._mb
    starts = np.array([37, 300, 611, 950], np.int32)[:S]
    bt = np.zeros((S, MB), np.int32)
    perm = rng.permutation(np.arange(1, eng.cfg.num_blocks))
    for b in range(S):
        n = int(starts[b]) // eng.cfg.block_size + 1
        bt[b, :n] = perm[b * MB:b * MB + n]
    inputs = {"ids": rng.integers(1, 32000, (S, 1)).astype(np.int32),
              "start": starts, "bt": bt}
    pools = [{kv: layer[kv].clone() for kv in ("k", "v")}
             for layer in eng._cache]
    graph = eng.tier.run("tick", eng._forward, inputs).clone()
    dev = eng.device
    eager, _ = eng.model(torch.as_tensor(inputs["ids"], device=dev),
                         cache=pools,
                         cache_index=torch.as_tensor(starts, device=dev),
                         block_tables=torch.as_tensor(bt, device=dev))
    torch.cuda.synchronize()
    err = float((graph - eager).abs().max())
    eps = torch.finfo(eng.model.cfg.compute_dtype).eps
    tol = 2 * eps * float(eager.abs().max())
    kv_equal = all(torch.equal(a[kv], b[kv])
                   for a, b in zip(eng._cache, pools) for kv in ("k", "v"))
    rec = {"bit_identical": bool(torch.equal(graph, eager)),
           "max_abs_err": err, "tol_2ulp_of_max": tol,
           "greedy_equal": bool(torch.equal(graph.argmax(-1),
                                             eager.argmax(-1))),
           "kv_equal": kv_equal}
    del pools
    rec["problems"] = [f"graph vs eager: {k}" for k in
                       ("greedy_equal", "kv_equal") if not rec[k]]
    if err > tol:
        rec["problems"].append(f"graph vs eager: logits differ by {err} "
                               f"> {tol}")
    return rec


def profiler_window(eng, rng, ticks: int = 8) -> dict:
    """`ticks` serve ticks of 4 decoding slots under torch.profiler: the
    hand kernels counted by name in what CUPTI saw run — the proof,
    apart from the wrappers' own counts, that they run inside the
    replayed graphs: paged attention (and its combine kernel, when the
    decode plan splits the chain) once a layer and RMSNorm 2 * layers +
    1 times a tick."""
    from hyperion_tpu_torch.ops import paged_attention as pa
    from hyperion_tpu_torch.serve.queue import Request

    cfg, S = eng.model.cfg, eng.cfg.slots
    reqs = [Request(prompt_ids=rng.integers(1, 32000, 24 + 8 * i)
                    .astype(np.int32), max_new_tokens=4 * ticks,
                    id=f"w{i}") for i in range(S)]
    for r in reqs:
        ok, why = eng.submit(r)
        assert ok, why
    while len(eng.queue) or any(r.first_token_at is None for r in reqs):
        eng.step()
    tick0, fwd0 = eng._tick_no, eng.forwards
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    ran = {"ticks": eng._tick_no - tick0, "forwards": eng.forwards - fwd0}
    while not eng.idle:
        eng.step()
    counts = {"paged_attention_kernel": 0, "paged_attention_combine_kernel": 0,
              "rmsnorm": 0, "graph_launches": 0}
    names = {}
    for e in prof.key_averages():
        name = e.key
        names[name[:80]] = e.count
        if "paged_attention_combine_kernel" in name:
            counts["paged_attention_combine_kernel"] += e.count
        elif "paged_attention_kernel" in name:
            counts["paged_attention_kernel"] += e.count
        elif "rmsnorm" in name and "bwd" not in name and "dw" not in name:
            counts["rmsnorm"] += e.count
        elif "cudaGraphLaunch" in name:
            counts["graph_launches"] += e.count
    plan = pa.plan(S, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   eng.cfg.block_size, eng._mb)
    L = cfg.n_layers
    expected = {"paged_attention_kernel": ticks * L,
                "paged_attention_combine_kernel":
                    ticks * L if plan.n_splits > 1 else 0,
                "rmsnorm": ticks * (2 * L + 1)}
    rec = {"ran": ran, "counts": counts, "expected": expected,
           "plan": dataclasses.asdict(plan), "problems": []}
    if ran != {"ticks": ticks, "forwards": ticks}:
        rec["problems"].append(f"profiler window ran {ran}")
    for k, v in expected.items():
        if counts[k] != v:
            rec["problems"].append(f"profiler window: {k} {counts[k]} != {v}")
    if rec["problems"]:
        rec["events"] = dict(sorted(names.items(), key=lambda kv: -kv[1])[:25])
    return rec


CRASH_DIR = Path("build/chip_smoke_crash")


def crash_requests(rng) -> list[dict]:
    """Three requests, one sampled with a seed: prompts of 20, 33 and 47
    tokens (the 64-token bucket warms them), 16-24 tokens each."""
    reqs = []
    for i, (n, budget) in enumerate(((20, 16), (33, 20), (47, 24))):
        r = {"id": f"c{i}", "prompt_ids": rng.integers(1, 32000, n)
             .astype(int).tolist(), "max_new_tokens": budget}
        if i == 1:
            r.update(temperature=0.8, top_p=0.9, seed=7)
        reqs.append(r)
    return reqs


def phase_crash() -> tuple[dict, torch.nn.Module]:
    """Leg 6 of scripts/serve_smoke.sh on the card: the port's server
    over a seeded random Llama-2-7B-width export (2 layers, fp32) runs
    under `--supervise` with a journal and `--chaos crash@tick=2`, so its
    first life dies hard (`os._exit`) mid-decode and the second replays
    the journal. The client's one stdout stream must carry every token
    once, in index order, bit-identical to an uninterrupted in-process
    engine over the same export; the journal drains clean; one restart,
    the heartbeat's `attempt` 1, a flight record with its final tick,
    and a compile ledger in each life with no recompile. Returns the
    record and the reference model (for the introspect phase). `main`
    runs its two halves apart (`crash_start`, `crash_finish`), with the
    gather and route phases between them while the server runs."""
    return crash_finish(crash_start())


def crash_start() -> dict:
    """The crash phase up to its running server: the export, the model
    loaded from it, the supervised server started on the requests (its
    output into files under CRASH_DIR), and the uninterrupted in-process
    engine's streams. Returns what `crash_finish` checks."""
    import os
    import shutil
    import threading

    from hyperion_tpu_torch.checkpoint.io import export_gathered, load_gathered
    from hyperion_tpu_torch.infer.generate import model_from_npz
    from hyperion_tpu_torch.models.llama import (
        Llama,
        llama2_7b_config,
        params_to_jax,
    )
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.queue import Request

    t0 = time.perf_counter()
    shutil.rmtree(CRASH_DIR, ignore_errors=True)
    CRASH_DIR.mkdir(parents=True)
    ckpt, journal = CRASH_DIR / "llama.npz", CRASH_DIR / "journal.jsonl"
    tele = CRASH_DIR / "tele" / "telemetry.jsonl"
    src = Llama(llama2_7b_config(n_layers=2, max_len=256, dtype="float32"),
                device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 10))
    export_gathered(ckpt, params_to_jax(src))
    del src
    model, _ = model_from_npz(load_gathered(ckpt), 256, dtype="float32",
                              device="cuda")
    export_s = time.perf_counter() - t0
    reqs = crash_requests(np.random.default_rng(SEED + 11))

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, HYPERION_TELEMETRY=str(tele),
               PYTHONPATH=str(repo))
    env.pop("HYPERION_ATTEMPT", None)
    t1 = time.perf_counter()
    out, err = open(CRASH_DIR / "server.out", "w"), \
        open(CRASH_DIR / "server.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperion_tpu_torch.serve.server",
         "--ckpt", str(ckpt), "--no-tokenizer", "--device", "cuda",
         "--dtype", "float32", "--max-len", "256", "--slots", "4",
         "--warmup-lens", "64", "--journal", str(journal), "--supervise",
         "--max-restarts", "2", "--hang-timeout", "0",
         "--chaos", "crash@tick=2"],
        stdin=subprocess.PIPE, stdout=out, stderr=err, env=env, text=True,
        cwd=repo, start_new_session=True)
    proc.stdin.write("".join(json.dumps(r) + "\n" for r in reqs))
    proc.stdin.close()
    ended: dict = {}

    def waiter():
        proc.wait()
        ended["t"] = time.perf_counter()

    threading.Thread(target=waiter, daemon=True).start()

    ref = Engine(model, EngineConfig(slots=4, max_len=256), device="cuda")
    ref.warmup([64])
    ref_reqs = [Request(prompt_ids=np.asarray(r["prompt_ids"], np.int32),
                        max_new_tokens=r["max_new_tokens"], id=r["id"],
                        temperature=r.get("temperature", 0.0),
                        top_p=r.get("top_p", 1.0), seed=r.get("seed", 0))
                for r in reqs]
    drive(ref, ref_reqs)
    del ref
    return {"model": model, "reqs": reqs, "ref_reqs": ref_reqs,
            "proc": proc, "files": (out, err), "t1": t1, "ended": ended,
            "export_s": export_s, "journal": journal, "tele": tele}


def crash_finish(st: dict) -> tuple[dict, torch.nn.Module]:
    """The crash phase from its server's exit (400 s after its start at
    most; then its process group is killed): the checks of
    `phase_crash`."""
    import os
    import signal

    from hyperion_tpu_torch.obs.heartbeat import read_heartbeat
    from hyperion_tpu_torch.obs.tickprof import flight_final_tick, read_flight
    from hyperion_tpu_torch.serve.journal import RequestJournal

    proc, t1 = st["proc"], st["t1"]
    model, reqs, ref_reqs = st["model"], st["reqs"], st["ref_reqs"]
    journal, tele, export_s = st["journal"], st["tele"], st["export_s"]
    try:
        proc.wait(timeout=max(1.0, 400 - (time.perf_counter() - t1)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        raise
    finally:
        for f in st["files"]:
            f.close()
    serve_s = st["ended"].get("t", time.perf_counter()) - t1
    stdout = (CRASH_DIR / "server.out").read_text()
    stderr = (CRASH_DIR / "server.err").read_text()

    streams: dict[str, list] = {}
    dones: dict[str, int] = {}
    for line in stdout.splitlines():
        try:
            x = json.loads(line)
        except json.JSONDecodeError:
            continue  # chaos chatter on the shared stdout
        if x.get("event") == "token":
            streams.setdefault(x["id"], []).append((x["i"], x["token"]))
        elif x.get("event") == "done":
            dones[x["id"]] = dones.get(x["id"], 0) + 1

    records = [json.loads(x) for x in tele.read_text().splitlines()
               if x.strip()]
    ledgers = [r for r in records if r.get("name") == "compile_ledger"]
    hb = read_heartbeat(tele.parent / "heartbeat.json") or {}
    flight = read_flight(tele.parent / "flight.json")
    rec = {
        "phase": "crash", "layers": 2, "dtype": "float32",
        "export_s": export_s, "serve_s": serve_s, "rc": proc.returncode,
        "restarts": stderr.count("[serve-supervisor] child exit 70"),
        "requests": len(reqs), "dones": dones,
        "tokens": {k: len(v) for k, v in streams.items()},
        "equal": {r.id: [t for _, t in streams.get(r.id, [])] == r.tokens
                  for r in ref_reqs},
        "replayed": sum(1 for r in records
                        if r.get("name") == "request_admitted"
                        and r.get("replayed")),
        "pending": RequestJournal(journal).pending_count(),
        "heartbeat_attempt": hb.get("attempt"),
        "flight_final_tick": flight_final_tick(flight) if flight else None,
        "compile_ledgers": len(ledgers),
        "ledger_stats": [{k: v for k, v in r.items()
                          if k.endswith("_executables")} for r in ledgers],
        "recompiles": sum(1 for r in records
                          if r.get("name") == "recompile_after_warmup"),
    }
    # the supervisor's verdict on the dead life; the port's obs tools on
    # the serve dir
    problems: list[str] = []
    summary = obs_cli("summarize", str(tele))
    rec["obs"] = {
        "logged": logged_verdicts(stderr),
        "summarize_rc": summary["rc"],
        "summarize_steps": next((x for x in summary["out"].splitlines()
                                 if x.startswith("| steps |")), None),
        "doctor": doctor_check(tele.parent, "healthy", problems,
                               "crash: the drained last life")}
    if rec["obs"]["logged"] not in ([(70, "running")], [(70, "crashed")]):
        problems.append(f"crash: supervisor logged {rec['obs']['logged']}")
    if summary["rc"] or "Telemetry summary" not in summary["out"]:
        problems.append(f"crash: obs summarize exit {summary['rc']}: "
                        f"{summary['err'][-500:]}")
    if rec["obs"]["doctor"]["attempt"] != 1:
        problems.append(f"crash: doctor {rec['obs']['doctor']}")
    emit(rec)
    if proc.returncode != 0:
        problems.append(f"server exit {proc.returncode}: "
                        f"{stderr[-2000:]}")
    if rec["restarts"] != 1:
        problems.append(f"{rec['restarts']} restarts, not 1")
    for r in ref_reqs:
        idx = [i for i, _ in streams.get(r.id, [])]
        if idx != list(range(len(r.tokens))):
            problems.append(f"{r.id}: stream indices {idx}")
        if dones.get(r.id) != 1:
            problems.append(f"{r.id}: {dones.get(r.id, 0)} done lines")
        if not rec["equal"][r.id]:
            problems.append(f"{r.id}: continuation differs from the "
                            "uninterrupted engine")
    if rec["replayed"] < 1:
        problems.append("nothing replayed: the crash missed the decode")
    if rec["pending"]:
        problems.append(f"journal still owes {rec['pending']}")
    if rec["heartbeat_attempt"] != 1:
        problems.append(f"heartbeat attempt {rec['heartbeat_attempt']}")
    if rec["flight_final_tick"] is None:
        problems.append("no well-formed flight record")
    if rec["compile_ledgers"] != 2 or rec["recompiles"]:
        problems.append(f"{rec['compile_ledgers']} compile ledgers, "
                        f"{rec['recompiles']} recompiles")
    if problems:
        raise AssertionError("crash: " + "; ".join(problems))
    return rec, model


def phase_gather(model, smi: str) -> dict:
    """The crash phase's 2-layer fp32 export served at temperature 0
    through both paged reads on the card (`serve --paged-attn`):
    `"pallas"`, the kernel, and `"gather"`, the plain gather read, each
    in an engine with its CUDA graphs. The gather run launches no paged
    kernel and its memory ledger counts its per-tick copy (slots x MB x
    block bytes), the kernel's none; its streams equal the kernel's, or
    part from them only at a near tie (a top-2 logit margin within
    1e-3, where another rounding of the same sums picks the other
    token). The model is left on the kernel."""
    from hyperion_tpu_torch.models.llama import set_paged_attn
    from hyperion_tpu_torch.ops.paged_attention import paged_attention
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.queue import Request

    reqs = crash_requests(np.random.default_rng(SEED + 12))
    runs = {}
    try:
        for impl in ("pallas", "gather"):
            set_paged_attn(model, impl)
            eng = Engine(model, EngineConfig(slots=4, max_len=256),
                         device="cuda")
            eng.warmup([64])
            rs = [Request(prompt_ids=np.asarray(r["prompt_ids"], np.int32),
                          max_new_tokens=r["max_new_tokens"], id=r["id"])
                  for r in reqs]
            before = paged_attention.launches
            drive(eng, rs)
            runs[impl] = {
                "tokens": {r.id: r.tokens for r in rs},
                "launches": paged_attention.launches - before,
                "gather_bytes": eng.memory_ledger()[
                    "kv_gather_bytes_per_tick"],
                "copy_bytes": 4 * eng._mb * eng._block_bytes}
            del eng
    finally:
        set_paged_attn(model, "pallas")
    results = [near_tie_record(model, model.cfg, r["id"],
                               np.asarray(r["prompt_ids"]),
                               runs["gather"]["tokens"][r["id"]],
                               runs["pallas"]["tokens"][r["id"]])
               for r in reqs]
    rec = {"phase": "gather", "nvidia_smi": smi, "layers": 2,
           "dtype": "float32", "requests": len(reqs), "streams": results,
           **{f"{impl}_{k}": v for impl, run in runs.items()
              for k, v in run.items() if k != "tokens"}}
    emit(rec)
    problems = []
    if rec["gather_launches"] or not rec["pallas_launches"]:
        problems.append(f"paged launches: gather {rec['gather_launches']}, "
                        f"kernel {rec['pallas_launches']}")
    if rec["gather_gather_bytes"] != rec["gather_copy_bytes"] \
            or rec["pallas_gather_bytes"] != 0:
        problems.append(f"ledger gather bytes {rec}")
    if beyond_near_tie(results):
        problems.append(f"streams {beyond_near_tie(results)}")
    if problems:
        raise AssertionError("gather: " + "; ".join(problems))
    return rec


ROUTE_DIR = Path("build/chip_smoke_route")
ROUTE_WORDS = ("the model serves tokens over a socket and the router sends "
               "each request to the replica with the least load while the "
               "journal keeps every dispatch so a crash loses nothing and a "
               "client resumes its stream from the next index it is owed "
               "in order once").split()


def route_corpus(rng) -> list[str]:
    """The text the route phase trains its tokenizer on: seeded lines of
    400 words built from 60 syllables, so pairs repeat and all 512 merges
    are learned."""
    syllables = ["".join(rng.choice(list("bcdfghklmnprstvz"))
                         + rng.choice(list("aeiou"))
                         + ("" if rng.random() < 0.5
                            else rng.choice(list("nrst"))))
                 for _ in range(60)]
    words = ["".join(rng.choice(syllables, int(rng.integers(1, 4))))
             for _ in range(400)]
    return [" ".join(rng.choice(words + list(ROUTE_WORDS), 14))
            for _ in range(4000)]


def route_requests(rng, n: int, tag: str) -> list[dict]:
    """`n` requests of 20..60 tokens (the 64-token bucket every replica
    warms), 16-24 new tokens: one text prompt, one sampled with a seed,
    two sharing a session, the rest prompt_ids."""
    reqs = []
    for i in range(n):
        r = {"id": f"{tag}{i}", "max_new_tokens": int(rng.integers(16, 25))}
        if i == 0:
            r["prompt"] = " ".join(rng.choice(ROUTE_WORDS, 12))
        else:
            r["prompt_ids"] = rng.integers(1, 32000, int(rng.integers(
                20, 61))).astype(int).tolist()
        if i == 1:
            r.update(temperature=0.8, top_p=0.9, seed=int(rng.integers(1e6)))
        if i in (2, 3):
            r["session_id"] = f"{tag}_sess"
        reqs.append(r)
    return reqs


def _wait_for(pred, timeout_s: float, what: str, proc=None) -> None:
    end = time.perf_counter() + timeout_s
    while not pred():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"route: {what}: router exited "
                                 f"{proc.returncode}")
        if time.perf_counter() > end:
            raise AssertionError(f"route: {what} not within {timeout_s} s")
        time.sleep(0.2)


def _records(path: Path) -> list[dict]:
    out = []
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass  # a torn tail of a killed life
    return out


def _reap_group(pgid: int, grace_s: float = 30.0) -> None:
    """Wait for the router's process group (its replicas, adopted ones
    included) to exit, then SIGKILL whatever is left."""
    import os
    import signal

    end = time.perf_counter() + grace_s
    while time.perf_counter() < end:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.2)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _cuda_pids() -> list[int]:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _maps_cuda(pid: int) -> bool:
    """Whether the process has the CUDA driver or runtime mapped."""
    try:
        maps = Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False
    return "libcuda.so" in maps or "libcudart" in maps


def _route_argv(base: Path, ckpt: Path, tok_dir: Path,
                device: str) -> list[str]:
    return [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "route",
            "--replicas", "2", "--min-ready", "2", "--device", device,
            "--dtype", "float32", "--ckpt", str(ckpt),
            "--tokenizer-dir", str(tok_dir), "--base-dir", str(base),
            "--max-len", "256", "--slots", "4", "--warmup-lens", "64",
            "--replica-heartbeat-every", "1", "--hang-timeout", "0",
            "--ready-timeout", "300",
            # an idle replica beats every 15 s (obs/heartbeat.py), past
            # the router's 10 s default: the pauses here (a profiler's
            # first start takes seconds) would eject idle replicas as
            # stale
            "--stale-s", "30"]


def _stream_problems(tag: str, streams: dict, dones: dict, ref) -> list:
    problems = []
    for r in ref:
        got = streams.get(r.id, [])
        if [i for i, _ in got] != list(range(len(got))) or not got:
            problems.append(f"{tag} {r.id}: stream indices "
                            f"{[i for i, _ in got]}")
        if dones.get(r.id) != 1:
            problems.append(f"{tag} {r.id}: {dones.get(r.id, 0)} done lines")
        if [t for _, t in got] != r.tokens:
            problems.append(f"{tag} {r.id}: stream differs from the "
                            "uninterrupted engine")
    return problems


def phase_route(model, smi: str, device: str = "cuda") -> dict:
    """The port's router over two port replicas on the card, each a
    process with its own CUDA context, serving the crash phase's export
    (Llama-2-7B widths, 2 layers, fp32; the same `model` is the
    uninterrupted in-process reference). A tokenizer trained here with
    512 merges serves a text prompt. Leg 1, stdin: replica 1 dies at its
    third tick (`--replica-chaos 1:crash@tick=3`), the router re-dispatches
    its streams, the replica restarts and its journal drains, and one
    replica's `profile` verb traces the paged kernel. Leg 2, a socket:
    the router itself runs `--supervise` and dies at its fifth dispatch
    (`--chaos crash@dispatch=5`); the next life adopts the replicas and
    recovers the WAL, and `ServeClient(resume=True)` streams ride across.
    Every stream exactly once, in order, equal to the in-process engine;
    no recompile in any replica; the router holds no CUDA context.
    `device` is for rehearsing the flow on the CPU with a tiny export."""
    import os
    import shutil
    import signal
    import threading

    from hyperion_tpu_torch.data.bpe import train_bpe
    from hyperion_tpu_torch.obs.export import exposition_path, request_control
    from hyperion_tpu_torch.obs.heartbeat import read_heartbeat
    from hyperion_tpu_torch.serve.client import ServeClient
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.journal import RequestJournal
    from hyperion_tpu_torch.serve.queue import Request
    from hyperion_tpu_torch.utils.profiling import TRACE_NAME

    t0 = time.perf_counter()
    shutil.rmtree(ROUTE_DIR, ignore_errors=True)
    ROUTE_DIR.mkdir(parents=True)
    ckpt = CRASH_DIR / "llama.npz"
    rng = np.random.default_rng(SEED + 30)
    tok = train_bpe(route_corpus(rng), vocab_size=256 + 1 + 512)
    tok_dir = ROUTE_DIR / "tokenizer"
    tok.save(tok_dir)
    leg1 = route_requests(rng, 8, "r")
    leg2 = route_requests(rng, 6, "v")
    for r in leg2:
        r["max_new_tokens"] = 48  # streams still open at the crash

    def reference(reqs):
        # the replicas' eos is the tokenizer's
        eng = Engine(model, EngineConfig(slots=4, max_len=256,
                                         eos_id=tok.eos_id), device=device)
        eng.warmup([64])
        out = [Request(prompt_ids=np.asarray(
            r["prompt_ids"] if "prompt_ids" in r else tok.encode(r["prompt"]),
            np.int32), max_new_tokens=r["max_new_tokens"], id=r["id"],
            temperature=r.get("temperature", 0.0), top_p=r.get("top_p", 1.0),
            seed=r.get("seed", 0)) for r in reqs]
        drive(eng, out)
        return out

    ref1, ref2 = reference(leg1), reference(leg2)
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    for k in ("HYPERION_TELEMETRY", "HYPERION_ATTEMPT", "HYPERION_HEARTBEAT"):
        env.pop(k, None)
    problems: list[str] = []
    rec: dict = {"phase": "route", "nvidia_smi": smi, "layers": 2,
                 "dtype": "float32", "merges": len(tok.merges)}

    # ---- leg 1: a replica crash under the stdin router
    base1 = ROUTE_DIR / "leg1"
    wal1 = ROUTE_DIR / "leg1_router_journal.jsonl"
    err1 = open(ROUTE_DIR / "leg1.err", "w")
    t1 = time.perf_counter()
    proc = subprocess.Popen(
        _route_argv(base1, ckpt, tok_dir, device)
        + ["--router-journal", str(wal1), "--replica-chaos", "1:crash@tick=3"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err1, text=True,
        env=env, cwd=repo, start_new_session=True)
    lines: list[dict] = []

    def read_wire():
        for line in proc.stdout:
            lines.append(json.loads(line))  # the router's stdout is wire only

    reader = threading.Thread(target=read_wire, daemon=True)
    reader.start()
    try:
        hb_paths = [base1 / f"replica_{i}" / "heartbeat.json" for i in (0, 1)]
        _wait_for(lambda: all((read_heartbeat(p) or {}).get("phase", "")
                              .startswith("serve") for p in hb_paths)
                  and exposition_path(hb_paths[0]).exists(), 300,
                  "both replicas serving", proc)
        rec["replicas_ready_s"] = time.perf_counter() - t1
        prof_dir = ROUTE_DIR / "profile"
        # the verb answers once the profiler runs; its first start in a
        # process (CUPTI's setup) takes seconds, so the requests go out
        # after the answer and their ticks fall inside the 2 s window
        tp = time.perf_counter()
        rec["profile"] = request_control(
            exposition_path(hb_paths[0]),
            {"cmd": "profile", "out": str(prof_dir), "seconds": 2.0},
            timeout_s=120.0) or {}
        rec["profile_start_s"] = time.perf_counter() - tp
        proc.stdin.write("".join(json.dumps(r) + "\n" for r in leg1))
        proc.stdin.flush()
        _wait_for(lambda: sum(x.get("event") == "done" for x in lines)
                  >= len(leg1), 180, "every leg-1 request done", proc)
        rec["leg1_served_s"] = time.perf_counter() - t1
        j1 = base1 / "replica_1" / "journal.jsonl"
        _wait_for(lambda: (read_heartbeat(hb_paths[1]) or {}).get("attempt")
                  == 1 and RequestJournal(j1).pending_count() == 0, 180,
                  "replica 1 restarted with its journal drained", proc)
        rec["replica_restart_s"] = time.perf_counter() - t1
        replica_pids = [(read_heartbeat(p) or {}).get("pid")
                        for p in hb_paths]
        cuda_pids = _cuda_pids()
        rec["cuda_context"] = {
            "router_pid": proc.pid, "replica_pids": replica_pids,
            "compute_apps": cuda_pids,
            "router_in_compute_apps": proc.pid in cuda_pids,
            "router_maps_cuda": _maps_cuda(proc.pid),
            "replicas_map_cuda": [_maps_cuda(p) for p in replica_pids]}
        proc.stdin.close()
        rc1 = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        _reap_group(proc.pid)
        err1.close()
    reader.join(timeout=10)
    rec["leg1_s"] = time.perf_counter() - t1
    streams: dict = {}
    dones: dict = {}
    for x in lines:
        if x.get("event") == "token":
            streams.setdefault(x["id"], []).append((x["i"], x["token"]))
        elif x.get("event") == "done":
            dones[x["id"]] = dones.get(x["id"], 0) + 1
    if rc1 != 0:
        problems.append(f"leg 1 router exit {rc1}: "
                        f"{(ROUTE_DIR / 'leg1.err').read_text()[-2000:]}")
    problems += _stream_problems("leg 1", streams, dones, ref1)
    route1 = _records(base1 / "telemetry.jsonl")
    ends = [x for x in route1 if x.get("name") == "router_end"]
    end1 = ends[-1] if ends else {}
    rec["leg1_router_end"] = {k: end1.get(k) for k in (
        "dispatched", "completed", "redispatched", "rejected",
        "failover_gap_p99_ms", "adopted", "orphans_recovered",
        "per_replica_restarts")}
    def t_of(recs, name, replica, after=0.0):
        return next((x["t_wall"] for x in recs if x.get("name") == name
                     and x.get("replica") == replica
                     and x["t_wall"] > after), None)

    died = t_of(route1, "replica_exit", 1)
    back = t_of(route1, "replica_readmitted", 1, after=died or 0.0)
    # the crashed replica's way back: process start, CUDA context, the
    # export's load, graph warmup (the kernels are built already)
    rec["replica1_exit_to_readmit_s"] = (back - died if died and back
                                         else None)
    if not end1.get("redispatched"):
        problems.append(f"leg 1: router_end {rec['leg1_router_end']}")
    if RequestJournal(base1 / "replica_1" / "journal.jsonl").pending_count():
        problems.append("leg 1: replica 1's journal still owes requests")
    for i in (0, 1):
        tele = _records(base1 / f"replica_{i}" / "telemetry.jsonl")
        rec[f"leg1_replica{i}_ledgers"] = sum(
            x.get("name") == "compile_ledger" for x in tele)
        if any(x.get("name") == "recompile_after_warmup" for x in tele):
            problems.append(f"leg 1: replica {i} recompiled")
    trace = prof_dir / TRACE_NAME
    _wait_for(trace.exists, 60, "the profile trace")
    time.sleep(1.0)  # the writer may still be finishing the file
    rec["trace_paged_kernels"] = sum(
        "paged_attention_kernel" in str(e.get("name", ""))
        for e in json.loads(trace.read_text()).get("traceEvents", []))
    if rec["merges"] != 512:
        problems.append(f"the tokenizer learned {rec['merges']} merges")
    if rec["profile"].get("status") != "started":
        problems.append(f"leg 1: profile verb answered {rec['profile']}")
    if not rec["trace_paged_kernels"]:
        problems.append("leg 1: the replica's profile trace holds no paged "
                        "kernel")
    # in a container nvidia-smi may list other pid numbers than the
    # processes see (pid 1 for each), so the maps are the check that
    # binds; the compute-apps list is recorded beside them
    cc = rec["cuda_context"]
    if cc["router_in_compute_apps"] or cc["router_maps_cuda"] \
            or not all(cc["replicas_map_cuda"]):
        problems.append(f"leg 1: CUDA contexts {cc}")
    # the port's obs tools on leg 1's router base dir: the doctor's fleet
    # rows, and the fleet trace's attribution summing to each measured
    # total (the router's relays joined to the replicas' phases)
    rec["leg1_doctor"] = doctor_check(base1, "healthy", problems,
                                      "leg 1 base dir")
    if [r for r, _ in rec["leg1_doctor"]["fleet"]] != ["0", "1"]:
        problems.append(f"leg 1: doctor fleet {rec['leg1_doctor']}")
    fleet = obs_cli("trace", str(base1), "--fleet", "--json", "--export",
                    str(ROUTE_DIR / "fleet_trace.json"))
    try:
        rows = json.loads(fleet["out"])["attribution"]["rows"]
    except (json.JSONDecodeError, KeyError):
        rows = []
    rec["leg1_fleet_trace"] = {
        "rc": fleet["rc"], "rows": [
            {k: r[k] for k in ("metric", "q", "value_ms", "other_ms",
                               "dominant")} for r in rows],
        "sum_err_ms": max((abs(sum(r["components_ms"].values())
                               + r["other_ms"] - r["value_ms"])
                           for r in rows), default=None)}
    if fleet["rc"] or not rows \
            or rec["leg1_fleet_trace"]["sum_err_ms"] > 0.005:
        problems.append(f"leg 1: obs trace --fleet {rec['leg1_fleet_trace']}"
                        f": {fleet['err'][-500:]}")

    # ---- leg 2: the router dies under --supervise, clients resume
    base2 = ROUTE_DIR / "leg2"
    sock = str(ROUTE_DIR / "route.sock")
    err2 = open(ROUTE_DIR / "leg2.err", "w")
    out2 = open(ROUTE_DIR / "leg2.out", "w")
    t2 = time.perf_counter()
    proc = subprocess.Popen(
        _route_argv(base2, ckpt, tok_dir, device)
        + ["--supervise", "--socket", sock, "--chaos", "crash@dispatch=5"],
        stdout=out2, stderr=err2, env=env, cwd=repo, start_new_session=True)
    results: dict = {}
    errors: list = []
    try:
        _wait_for(lambda: os.path.exists(sock), 300, "the router socket",
                  proc)
        rec["leg2_ready_s"] = time.perf_counter() - t2

        def client(r):
            got: list = []
            try:
                with ServeClient(sock, timeout_s=120.0, resume=True) as c:
                    for x in c.stream(**r):
                        got.append(x)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{r['id']}: {e!r}")
            results[r["id"]] = got

        threads = [threading.Thread(target=client, args=(r,)) for r in leg2]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        rec["leg2_served_s"] = time.perf_counter() - t2
        hb = read_heartbeat(base2 / "heartbeat.json") or {}
        if hb.get("pid"):
            os.kill(int(hb["pid"]), signal.SIGTERM)  # drain the router life
        rc2 = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        _reap_group(proc.pid)
        err2.close()
        out2.close()
    rec["leg2_s"] = time.perf_counter() - t2
    streams, dones = {}, {}
    for rid, recs in results.items():
        for x in recs:
            if x.get("event") == "token":
                streams.setdefault(rid, []).append((x["i"], x["token"]))
            elif x.get("event") == "done":
                dones[rid] = dones.get(rid, 0) + 1
    if errors or rc2 != 0:
        problems.append(f"leg 2: exit {rc2}, client errors {errors}: "
                        f"{(ROUTE_DIR / 'leg2.err').read_text()[-2000:]}")
    problems += _stream_problems("leg 2", streams, dones, ref2)
    route2 = _records(base2 / "telemetry.jsonl")
    names = [x.get("name") for x in route2]
    end2 = [x for x in route2 if x.get("name") == "router_end"]
    end2 = end2[-1] if end2 else {}
    rec["leg2_router_end"] = {k: end2.get(k) for k in (
        "dispatched", "completed", "redispatched", "adopted", "resumes",
        "orphans_recovered", "failover_gap_p99_ms")}
    rec["leg2_router_restarts"] = (ROUTE_DIR / "leg2.err").read_text().count(
        "[route-supervisor] router exit")
    life1 = route2[0].get("run") if route2 else None
    starts = [x["t_wall"] for x in route2 if x.get("name") == "router_start"
              and x.get("run") != life1]
    last1 = max((x.get("t_wall", 0.0) for x in route2
                 if x.get("run") == life1), default=None)
    # the router's own death to its next life's start
    rec["leg2_router_restart_s"] = (starts[0] - last1 if starts and last1
                                    else None)
    rec["leg2_events"] = {n: names.count(n) for n in (
        "replica_adopted", "route_resume", "route_orphan_recovered")}
    if rec["leg2_router_restarts"] != 1 \
            or rec["leg2_events"]["replica_adopted"] < 2 \
            or not (rec["leg2_events"]["route_resume"]
                    or rec["leg2_events"]["route_orphan_recovered"]):
        problems.append(f"leg 2: restarts {rec['leg2_router_restarts']}, "
                        f"events {rec['leg2_events']}")
    for i in (0, 1):
        if any(x.get("name") == "recompile_after_warmup" for x in _records(
                base2 / f"replica_{i}" / "telemetry.jsonl")):
            problems.append(f"leg 2: replica {i} recompiled")
    rec["leg2_logged"] = logged_verdicts((ROUTE_DIR / "leg2.err").read_text())
    if len(rec["leg2_logged"]) != 1 or rec["leg2_logged"][0][1] not in (
            "running", "crashed"):
        problems.append(f"leg 2: route supervisor logged "
                        f"{rec['leg2_logged']}")
    rec["leg2_doctor"] = doctor_check(base2, "healthy", problems,
                                      "leg 2 base dir")
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if problems:
        raise AssertionError("route: " + "; ".join(problems))
    return rec


def phase_introspect(model) -> dict:
    """A port engine serving behind a `MetricsExporter`: the exposition
    snapshot carries the compile counts, the tick profiler and the memory
    ledger; `class_brownout` on and off is acknowledged and its gauge
    follows; `profile` for 2 s, with the engine serving across the
    profiler's stop, writes a trace in which the paged kernel appears.
    A hang dumps every thread's stack and ends the script."""
    import faulthandler
    import shutil

    from hyperion_tpu_torch.obs.export import (
        MetricsExporter,
        read_exposition,
        request_control,
    )
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.graphs import STAT_KEYS
    from hyperion_tpu_torch.serve.queue import Request
    from hyperion_tpu_torch.utils.profiling import TRACE_NAME

    base = Path("build/chip_smoke_introspect")
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 12)
    faulthandler.dump_traceback_later(300, exit=True)
    eng = Engine(model, EngineConfig(slots=4, max_len=256), device="cuda")
    eng.warmup([64])
    n = 0

    def serve_for(seconds: float) -> None:
        nonlocal n
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            while len(eng.queue) + eng.n_active < 4:
                eng.submit(Request(prompt_ids=rng.integers(1, 32000, 40)
                                   .astype(np.int32), max_new_tokens=64,
                                   id=f"x{n}"))
                n += 1
            eng.step()

    problems = []
    sock = base / "obs.sock"
    with MetricsExporter(sock, eng.exposition, label="smoke-obs",
                         control_fn=eng.control):
        serve_for(0.5)
        doc = read_exposition(sock) or {}
        comp = doc.get("compile", {})
        if set(comp) != {*STAT_KEYS.values(), "recompiles"} \
                or comp.get("recompiles"):
            problems.append(f"exposition compile {comp}")
        if not (doc.get("tickprof") or {}).get("ticks"):
            problems.append("exposition: no tickprof ticks")
        mem = doc.get("memory") or {}
        if mem.get("kv_gather_bytes_per_tick") != 0 \
                or not mem.get("kv_pool_bytes"):
            problems.append(f"exposition memory {mem}")
        gauge = []
        for active in (True, False):
            ack = request_control(sock, {"cmd": "class_brownout",
                                         "active": active}) or {}
            if ack.get("status") != "ok" or not ack.get("changed"):
                problems.append(f"class_brownout {active}: {ack}")
            serve_for(0.1)
            g = ((read_exposition(sock) or {}).get("metrics") or {}) \
                .get("gauges", {}).get("serve_class_brownout")
            gauge.append(g)
        if gauge != [1.0, 0.0]:
            problems.append(f"serve_class_brownout gauge {gauge}")
        prof_dir = base / "profile"
        started = request_control(sock, {"cmd": "profile",
                                         "out": str(prof_dir),
                                         "seconds": 2.0}) or {}
        if started.get("status") != "started":
            problems.append(f"profile: {started}")
        serve_for(2.5)  # serving goes on across the profiler's stop
    trace = prof_dir / TRACE_NAME
    deadline = time.perf_counter() + 60
    while not trace.exists() and time.perf_counter() < deadline:
        time.sleep(0.5)
    time.sleep(1.0)  # the writer may still be finishing the file
    paged = 0
    if trace.exists():
        events = json.loads(trace.read_text()).get("traceEvents", [])
        paged = sum(1 for e in events
                    if "paged_attention_kernel" in str(e.get("name", "")))
    if not paged:
        problems.append(f"profile trace {trace} holds no paged kernel")
    while not eng.idle:
        eng.step()
    faulthandler.cancel_dump_traceback_later()
    rec = {"phase": "introspect", "compile": comp,
           "tickprof_ticks": (doc.get("tickprof") or {}).get("ticks"),
           "dominant_segment": (doc.get("tickprof") or {}).get("dominant"),
           "memory": mem, "class_brownout_gauge": gauge,
           "profile": started, "trace_paged_kernels": paged,
           "requests_served": n}
    emit(rec)
    if problems:
        raise AssertionError("introspect: " + "; ".join(problems))
    return rec


# --- the distributed runtime and the sharded layouts ------------------

FSDP_DIR = Path("build/chip_smoke_fsdp")
FSDP_STEPS, FSDP_SIGTERM = 50, 30
LLAMA_FSDP_STEPS, LLAMA_FSDP_EVALS = 4, 1


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(argv: list[str], timeout_s: float, env: dict | None = None) -> dict:
    """Run a command from the checkout's root in its own session; kill
    the session at `timeout_s` or on any exit path."""
    import os

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, **(env or {})})
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise TimeoutError(f"{argv} ran past {timeout_s} s") from e
    finally:
        if proc.poll() is None:
            _reap_group(proc.pid, grace_s=5.0)
            proc.wait()
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "log": out}


def _torchrun(*argv: str, timeout_s: float = 600,
              env: dict | None = None) -> dict:
    """`torchrun --standalone --nproc-per-node 1 ARGV` (one rank)."""
    return _run([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "1", *argv],
                timeout_s, env)


def _zero_lm_launches() -> None:
    from hyperion_tpu_torch.ops.fused_ce import (
        fused_softmax_xent_bwd,
        fused_softmax_xent_fwd,
    )
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm

    for fn in (fused_layernorm, fused_softmax_xent_fwd,
               fused_softmax_xent_bwd):
        fn.launches = 0


def _lm_launches() -> dict:
    from hyperion_tpu_torch.ops.fused_ce import (
        fused_softmax_xent_bwd,
        fused_softmax_xent_fwd,
    )
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm

    return {"fused_layernorm": fused_layernorm.launches,
            "fused_softmax_xent_fwd": fused_softmax_xent_fwd.launches,
            "fused_softmax_xent_bwd": fused_softmax_xent_bwd.launches}


def _param_kinds(model) -> str:
    """"DTensor" when every parameter is sharded (FSDP2's), else the
    kinds found."""
    return "/".join(sorted({type(p).__name__ for p in model.parameters()}))


def fsdp_argv(base: Path, device: str = "cuda", steps: int = FSDP_STEPS,
              batch: int = 32, *extra: str) -> list[str]:
    """`train --model language_fsdp` at the train phase's config
    (`train_config`: one epoch of `steps`, jit+pallas, batch 32, seq
    128, bf16, the synthetic splits under `base`), the job's own lr and
    clip."""
    return ["--model", "language_fsdp", "--epochs", "1", "--steps-per-epoch",
            str(steps), "--batch_size", str(batch), "--compile-tier",
            "jit+pallas", "--base_dir", str(base), "--data_dir",
            str(base / "no_data"), "--device", device, *extra]


# the MoE run's flags: language_ddp's widths, 4 experts, top-2, every
# second block sparse
MOE_FLAGS = ("--moe_experts", "4", "--moe_top_k", "2", "--moe_every", "2")
RING_STEPS = 4


def axes_argv(base: Path, device: str, *extra: str) -> list[str]:
    """`train --model language_ddp` at jit+pallas, one epoch, the
    synthetic splits under `base`, then `extra` (steps, widths, the
    axes' flags)."""
    return ["--model", "language_ddp", "--epochs", "1", "--compile-tier",
            "jit+pallas", "--base_dir", str(base), "--data_dir",
            str(base / "no_data"), "--device", device, *extra]


def pipeline_lm_run(device: str, batch: int) -> dict:
    """`PipelinedLM(n_stages=2, n_microbatches=4)` at language_ddp's
    widths (2 layers, one a stage; bf16 compute over fp32 masters,
    jit+pallas norms) on this rank, against a TransformerLM from the
    same seeded init: its weights equal the stacked ones leaf for leaf,
    and the logits of a seeded ragged batch [batch, 128] must be
    bit-identical. Then one train step (the language trainer's layout
    and loss at world 1) with the kernel counts set to 0 before it."""
    from hyperion_tpu_torch.models.pipeline_lm import (
        PipelinedLM,
        PipelineLMConfig,
    )
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )
    from hyperion_tpu_torch.runtime.mesh import (
        AxisName,
        MeshSpec,
        make_mesh,
        set_active_mesh,
    )
    from hyperion_tpu_torch.train.losses import lm_loss
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer
    from hyperion_tpu_torch.train.step import make_train_step
    from hyperion_tpu_torch.train.trainer import _parallelize

    mesh = make_mesh(MeshSpec(), device)  # world 1: every axis 1
    set_active_mesh(mesh)
    c = simple_lm_config(max_len=128, dropout=0.1, dtype="bfloat16",
                         attention_impl="auto", norm_impl="pallas")
    pipe = PipelinedLM(PipelineLMConfig(c, n_stages=2, n_microbatches=4),
                       device=device).init_params(
        torch.Generator(device=device).manual_seed(SEED))
    plain = TransformerLM(c, device=device).init_params(
        torch.Generator(device=device).manual_seed(SEED))
    lps = pipe.pipe_cfg.layers_per_stage
    weights_equal = all(
        torch.equal(getattr(plain, f"block_{i}").get_parameter(n),
                    pipe.stages.get_parameter(n)[i // lps, i % lps])
        for i in range(c.n_layers) for n in pipe.stage_names) and all(
        torch.equal(p, pipe.get_parameter(k))
        for k, p in plain.named_parameters() if not k.startswith("block_"))
    rng = np.random.default_rng(SEED + 21)
    ids = torch.from_numpy(rng.integers(0, c.vocab_size, (batch, 128)))
    lens = rng.integers(64, 129, batch)
    mask = torch.from_numpy(
        (np.arange(128)[None] < lens[:, None]).astype(np.int64))
    ids, mask = ids.to(device), mask.to(device)
    with torch.no_grad():
        lp, lt = pipe(ids, padding_mask=mask), plain(ids, padding_mask=mask)
    rec = {"weights_equal": weights_equal,
           "logits_bit_identical": bool(torch.equal(lp, lt)),
           "logits_max_abs": float((lp - lt).abs().max()),
           "logits_shape": list(lp.shape), "n_stages": 2,
           "n_microbatches": 4, "layers_per_stage": lps}
    del lp, lt, plain
    sync, grad_sync = _parallelize(pipe, mesh, False, pipe.blocks,
                                   AxisName.LM_REPLICAS)
    state = TrainState(0, pipe, make_optimizer(pipe.parameters(), 2e-4))

    def loss_fn(model, b, gen):
        loss = lm_loss(model(b["input_ids"], padding_mask=b["attention_mask"],
                             deterministic=gen is None, generator=gen),
                       b, "pallas", sync)
        return loss, {"loss": loss}

    step = make_train_step(loss_fn, dropout=True, sync=sync,
                           grad_sync=grad_sync)
    before = {k: v.detach().clone() for k, v in pipe.state_dict().items()}
    _zero_all_launches()
    m = step(state, {"input_ids": ids, "attention_mask": mask}, SEED)
    rec.update(step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               launches=_all_launch_counts(),
               stage_leaves_moved=all(
                   not torch.equal(before[f"stages.{n}"],
                                   pipe.stages.get_parameter(n))
                   for n in pipe.stage_names))
    set_active_mesh(None)
    return rec


def axes_run(root: Path, device: str, name: str, *extra: str) -> dict:
    """`cli.main`'s language_ddp job on `axes_argv` + `extra` under
    `root / name`, every count set to 0 just before it; the run's
    readings (the MoE LM's routing counts too)."""
    from hyperion_tpu_torch.cli.main import build_parser, run_job
    from hyperion_tpu_torch.models.moe_lm import MoELM

    on_card = device == "cuda"
    base = root / name
    args = build_parser().parse_args(axes_argv(base, device, *extra))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _zero_all_launches()
    t0 = time.perf_counter()
    res = run_job(args, "language_ddp")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(res.csv_path) as f:
        rows = list(csv.DictReader(f))
    spans = [json.loads(x) for x in
             (base / "telemetry.jsonl").read_text().splitlines()]
    m = res.model
    rec = {"wall_s": wall, "losses": res.step_losses,
           "step_ms": res.step_ms, "launches": _all_launch_counts(),
           "eval_batches": sum(r.get("batches", 0) for r in spans
                               if r.get("name") == "eval"),
           "csv": rows, "layers": m.cfg.n_layers,
           "val_loss": res.history[-1].extra.get("val_loss")
           if res.history else None,
           "attention_impl": m.cfg.attention_impl,
           "dtype": m.cfg.dtype, "seq_len": m.cfg.max_len,
           "batch": args.batch_size,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
           if on_card else None,
           "gauges": gauge_readings(res)}
    if isinstance(m, MoELM):
        rec.update(dropped_share=m.dropped_share(),
                   moe_blocks=len(m.moe_blocks),
                   experts=m.moe_cfg.moe.n_experts,
                   top_k=m.moe_cfg.moe.top_k)
    res.model = None
    return rec


def axes_runs(root: Path, device: str, steps: str, batch: str,
              seq: str) -> dict:
    """The seq, pipe and expert runs of the sharded rank (a process
    group at world 1, so each axis is 1): the MoE LM (`MOE_FLAGS`,
    `steps` of `batch` at seq 128), train_long's config at Ulysses
    (seq `seq`), the same in fp32 at ring and at xla (RING_STEPS), and
    `pipeline_lm_run`. On the CPU the long runs take `batch` and 2
    steps for ring and xla."""
    on_card = device == "cuda"
    long_batch = str(LONG_BATCH) if on_card else batch
    rec = {"moe": axes_run(root, device, "moe", "--steps-per-epoch", steps,
                           "--batch_size", batch, *MOE_FLAGS)}
    rec["ulysses"] = axes_run(
        root, device, "ulysses", "--steps-per-epoch",
        str(LONG_STEPS) if on_card else steps, "--seq_len", seq,
        "--batch_size", long_batch, "--attention-impl", "ulysses")
    for impl in ("ring", "xla"):
        rec[impl] = axes_run(
            root, device, impl, "--steps-per-epoch",
            str(RING_STEPS if on_card else 2), "--seq_len", seq,
            "--batch_size", long_batch, "--precision", "fp32",
            "--attention-impl", impl)
    rec["pipeline"] = pipeline_lm_run(device, int(batch))
    return rec


def worker_sharded(out: str, root: str, device: str, steps: str,
                   batch: str, sigterm: str, model: str, seq: str) -> dict:
    """One torchrun rank, one process group, every sharded run in turn,
    each kernel count set to 0 just before its run: the comm check;
    `cli.main`'s job runner on `fsdp_argv` (language_fsdp under FSDP2),
    uninterrupted; the same stopped by `sigterm@step=N` and resumed
    from its sharded checkpoint; `train_llama` fsdp_bf16 at
    `llama_train_config` (LoRA off, no checkpoint or export); then
    `axes_runs` (the MoE LM, Ulysses, ring and its xla baseline, the
    pipelined LM)."""
    import torch.distributed as tdist

    from hyperion_tpu_torch.cli.main import build_parser, run_job
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.comm_check import comm_check
    from hyperion_tpu_torch.train.trainer import train_llama

    root = Path(root)
    on_card = device == "cuda"

    def lm(base: Path, *extra: str) -> dict:
        args = build_parser().parse_args(
            fsdp_argv(base, device, int(steps), int(batch), *extra))
        _zero_lm_launches()
        t0 = time.perf_counter()
        res = run_job(args, "language_fsdp")
        return {"preempted": res.preempted, "wall_s": time.perf_counter() - t0,
                "step_losses": res.step_losses, "step_ms": res.step_ms,
                "launches": _lm_launches(), "csv_path": res.csv_path,
                "params": _param_kinds(res.model),
                "gauges": gauge_readings(res)}

    def llama() -> dict:
        cfg = llama_train_config(root / "llama", LLAMA_FSDP_STEPS,
                                 LLAMA_FSDP_EVALS, int(seq))
        cfg.train.lora, cfg.train.model = False, model
        cfg.distributed.data, cfg.distributed.fsdp = 1, -1  # the CLI's
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = train_llama(cfg, device=device, save_state=False)
        m = res.model
        return {"wall_s": time.perf_counter() - t0, "model": model,
                "seq_len": cfg.train.seq_len, "params": _param_kinds(m),
                "param_dtype": str(next(m.parameters()).dtype),
                "layers": m.cfg.n_layers, "d_model": m.cfg.d_model,
                "n_params": sum(p.numel() for p in m.parameters()),
                "trained": sum(p.numel() for p in m.parameters()
                               if p.requires_grad),
                "losses": res.step_losses, "step_ms": res.step_ms,
                "val_loss": res.history[-1].extra.get("val_loss")
                if res.history else None,
                "launches": _launch_counts(), "csv_path": res.csv_path,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                if on_card else None,
                "reserved_peak_gb": torch.cuda.max_memory_reserved() / 1e9
                if on_card else None}

    try:
        dist.setup(device)
        rec = {"world": dist.process_count(), "backend": tdist.get_backend(),
               "comm_check": comm_check()}
        rec["sharded"] = lm(root / "sharded")
        rec["stopped"] = lm(root / "stopped", "--chaos",
                            f"sigterm@step={sigterm}")
        rec["resumed"] = lm(root / "stopped")
        rec["llama"] = llama()
        rec.update(axes_runs(root, device, steps, batch, seq))
        return rec
    finally:
        dist.cleanup()


def sharded_runs(device: str = "cuda", steps: int = FSDP_STEPS,
                 batch: int = 32, sigterm: int = FSDP_SIGTERM,
                 model: str = "llama_7b", seq: int = 4096) -> dict:
    """`worker_sharded` under `torchrun --standalone --nproc-per-node 1`
    (NCCL on the card), with the `--host-only` check of the host
    coordinator between two host processes (no card) beside it; the
    rank's readings, the host processes' exit codes and logs.
    `device="cpu"` (gloo), fewer steps, a smaller batch, `sigterm=3`,
    `model="llama_tiny"` and `seq=64` rehearse it on the CPU."""
    import os
    import shutil

    root = Path(__file__).resolve().parent / FSDP_DIR
    shutil.rmtree(root, ignore_errors=True)
    for name in ("sharded", "stopped", "plain", "moe", "ulysses", "ring",
                 "xla"):
        (root / name / "no_data").mkdir(parents=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    parent_gb = (torch.cuda.memory_reserved() / 1e9 if device == "cuda"
                 else None)  # what this process holds meanwhile
    port = str(_free_port())
    hosts = [subprocess.Popen(
        [sys.executable, "-m", "hyperion_tpu_torch.runtime.comm_check",
         "--host-only"], cwd=Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "HYPERION_COORD_PORT": port})
        for r in (0, 1)]
    out = root / "rank0.json"
    try:
        run = _torchrun(str(Path(__file__).resolve()), "--worker", "sharded",
                        str(out), str(root), device, str(steps), str(batch),
                        str(sigterm), model, str(seq), timeout_s=900,
                        env={"PYTORCH_CUDA_ALLOC_CONF":
                             "expandable_segments:True"})
        host_out = [h.communicate(timeout=120)[0] for h in hosts]
    finally:
        for h in hosts:
            if h.poll() is None:
                h.kill()
                h.wait()
    if run["rc"] != 0 or not out.exists():
        raise AssertionError(f"sharded rank: rc {run['rc']}\n"
                             + run["log"][-6000:])
    rec = json.loads(out.read_text())
    rec.update(process_s=run["seconds"], parent_reserved_gb=parent_gb,
               host_only_rcs=[h.returncode for h in hosts],
               host_only_logs=host_out, root=str(root))
    return rec


def phase_dist(smi: str, runs: dict) -> dict:
    """The collectives over the rank's group at world 1 (NCCL on the
    card) and the host coordinator between two host processes."""
    cc = runs["comm_check"]
    rec = {"phase": "dist", "nvidia_smi": smi, "world": runs["world"],
           "backend": runs["backend"],
           "collectives_ok": {k: v["ok"] for k, v in cc.items()},
           "collectives_ms": {k: v["ms"] for k, v in cc.items()},
           "ring_shift_note": cc.get("ring_shift", {}).get("note"),
           "host_only_rcs": runs["host_only_rcs"]}
    emit(rec)
    problems = []
    if set(cc) != {"all_reduce_sum", "all_reduce_max", "all_gather",
                   "reduce_scatter", "ring_shift"} \
            or not all(rec["collectives_ok"].values()):
        problems.append(f"collectives {rec['collectives_ok']}")
    if rec["ring_shift_note"] != "identity at world 1":
        problems.append("the ring shift did not say it is the identity")
    if runs["host_only_rcs"] != [0, 0] or not all(
            "HOST LAYER OK" in o for o in runs["host_only_logs"]):
        problems.append("host-only:\n" + "\n".join(
            o[-1500:] for o in runs["host_only_logs"]))
    if problems:
        raise AssertionError("dist: " + "; ".join(problems))
    return rec


def phase_train_fsdp(smi: str, runs: dict, device: str = "cuda",
                     steps: int = FSDP_STEPS, batch: int = 32) -> dict:
    """language_fsdp under FSDP2 at world 1 (the rank's runs) against
    the same config unsharded in this process, and the stopped run's
    resume against the uninterrupted one (see the module docstring)."""
    from hyperion_tpu_torch.cli.main import build_parser, make_config
    from hyperion_tpu_torch.train.trainer import train_language_model

    root = Path(runs["root"])
    a, b1, b2 = runs["sharded"], runs["stopped"], runs["resumed"]
    # the same config, unsharded: no process group in this process
    cfg = make_config(build_parser().parse_args(
        fsdp_argv(root / "plain", device, steps, batch)), "language_fsdp")
    plain = train_language_model(cfg, "language_fsdp", device=device)
    plain.model = None
    losses = np.asarray(a["step_losses"])
    ref = np.asarray(plain.step_losses)
    resumed = np.asarray(b1["step_losses"] + b2["step_losses"])
    with open(a["csv_path"]) as f:
        rows = list(csv.reader(f))
    spans = [json.loads(x) for x in (root / "sharded" / "telemetry.jsonl")
             .read_text().splitlines()]
    eval_batches = sum(r.get("batches", 0) for r in spans
                       if r.get("name") == "eval")
    final = "checkpoints/language_fsdp_final.npz"
    p50 = float(np.percentile(a["step_ms"], 50)) if a["step_ms"] else None
    sigterm = len(b1["step_losses"])
    rec = {
        "phase": "train_fsdp", "nvidia_smi": smi, "world": runs["world"],
        "params": a["params"], "steps": len(losses),
        "eval_batches": eval_batches,
        "loss_first10": float(losses[:10].mean()),
        "loss_last10": float(losses[-10:].mean()),
        "max_abs_loss_diff_vs_unsharded": float(np.abs(losses - ref).max())
        if len(ref) == len(losses) else None,
        "losses_bit_identical": bool(np.array_equal(losses, ref)),
        "step_ms_p50": p50,
        "unsharded_step_ms_p50": float(np.percentile(plain.step_ms, 50))
        if plain.step_ms else None,
        "tokens_per_s": batch * 128 / (p50 / 1e3) if p50 else None,
        "run_wall_s": a["wall_s"], "csv_rows": len(rows) - 1,
        "launches": a["launches"],
        "launches_expected": {
            "fused_layernorm": 5 * (steps + eval_batches),
            "fused_softmax_xent_fwd": steps + eval_batches,
            "fused_softmax_xent_bwd": steps},
        "checkpoint": ckpt_readings(root / "sharded", "language_fsdp_1dev"),
        "stopped_preempted": b1["preempted"], "stopped_steps": sigterm,
        "resumed_steps": len(b2["step_losses"]),
        "resume_losses_bit_identical": bool(np.array_equal(resumed, losses)),
        "resume_export_bit_identical": _export_equal(
            root / "sharded" / final, root / "stopped" / final),
        "gauges": a["gauges"],
    }
    emit(rec)
    problems = train_problems("train_fsdp", rec["checkpoint"], rec["gauges"])
    if runs["world"] != 1 or a["params"] != "DTensor":
        problems.append(f"world {runs['world']}, params {a['params']}")
    if not np.isfinite(losses).all() or len(losses) != steps:
        problems.append(f"losses {losses.tolist()}")
    if not rec["losses_bit_identical"]:
        problems.append("losses differ from the unsharded run by "
                        f"{rec['max_abs_loss_diff_vs_unsharded']}")
    if rec["csv_rows"] != 1:
        problems.append(f"csv {rows}")
    if b1["preempted"] is not True or not 0 < sigterm < steps:
        problems.append(f"sigterm leg: preempted {b1['preempted']}, "
                        f"{sigterm} steps")
    if not (rec["resume_losses_bit_identical"]
            and rec["resume_export_bit_identical"]):
        problems.append("the resumed run differs from the uninterrupted")
    if a["launches"] != rec["launches_expected"]:
        problems.append(f"launch counts {a['launches']} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("train_fsdp: " + "; ".join(problems))
    return rec


def moe_fp32_step(batch: int = 8, seed: int = SEED) -> dict:
    """One MoE LM step (the train_moe widths: d 256, 4 heads, 2 layers,
    ff 1024, GPT-2 vocab, 4 experts top-2 in the second block; dropout
    off) from the same seeded weights and batch on the card and on the
    CPU: fp32 at jit+pallas (the card runs the LayerNorm and CE kernels,
    the CPU their plain versions), then the same in float64 with the
    plain ops. The fp32 logits and loss are held to the cifar step's
    bounds (`phase_cifar`); the gradients are compared per leaf in float64
    (max|card - cpu| / max|cpu|; the k_proj biases' against the largest
    gradient of all, `grad_rel`), where the router stays fp32 by the
    reference's design (`ops/moe.py`), so float64 holds the rest of the
    network only."""
    from hyperion_tpu_torch.models.moe_lm import MoELM, MoELMConfig
    from hyperion_tpu_torch.models.transformer_lm import simple_lm_config
    from hyperion_tpu_torch.ops.moe import MoEConfig
    from hyperion_tpu_torch.train.losses import next_token_loss

    assert not torch.backends.cuda.matmul.allow_tf32  # main() turns it off
    rng = np.random.default_rng(seed + 31)
    ids = torch.from_numpy(rng.integers(0, 50257, (batch, 128)))
    lens = rng.integers(64, 129, batch)
    mask = torch.from_numpy(
        (np.arange(128)[None] < lens[:, None]).astype(np.int64))
    out, weights = {}, None
    for dtype, impl in (("float32", "pallas"), ("float64", "xla")):
        base = simple_lm_config(max_len=128, dropout=0.0, dtype=dtype,
                                norm_impl=impl)
        cfg = MoELMConfig(base, MoEConfig(
            n_experts=4, top_k=2, d_model=256, ff_dim=1024,
            activation=base.activation), moe_every=2)
        for dev in ("cuda", "cpu"):
            model = MoELM(cfg, device=dev)
            if weights is None:
                weights = {k: v.cpu() for k, v in model.init_params(
                    torch.Generator(device=dev).manual_seed(seed))
                    .state_dict().items()}
            model.load_state_dict(weights)
            model.to(getattr(torch, dtype))
            logits, aux = model.apply_with_aux(ids.to(dev),
                                               padding_mask=mask.to(dev))
            lm = next_token_loss(logits, ids.to(dev), mask.to(dev),
                                 impl=impl)
            loss = lm + aux
            loss.backward()
            out[dev, dtype] = {
                "logits": logits.detach().cpu().double(),
                "loss": float(loss), "aux": float(aux),
                "dropped": model.dropped_share(),
                "grads": {k: p.grad.detach().cpu().double()
                          for k, p in model.named_parameters()}}
            del model, logits
    card, cpu = out["cuda", "float32"], out["cpu", "float32"]

    def grad_rel(a: dict, b: dict) -> tuple[float, str]:
        """The largest over leaves of max|a - b| over the leaf's largest
        |b|; each k_proj bias, whose gradient is zero in exact
        arithmetic (a constant on every key's score leaves softmax
        unchanged: rounding noise on either device, ROADMAP C), over
        the largest of every leaf."""
        top = max(float(g.abs().max()) for g in b.values())
        rel = {k: float((a[k] - g).abs().max())
               / max(top if k.endswith("k_proj.bias")
                     else float(g.abs().max()), 1e-300)
               for k, g in b.items()}
        leaf = max(rel, key=rel.get)
        return rel[leaf], leaf

    g64, g64_leaf = grad_rel(out["cuda", "float64"]["grads"],
                             out["cpu", "float64"]["grads"])
    return {
        "batch": batch, "tf32": False,
        "logits_max_abs": float((card["logits"] - cpu["logits"]).abs().max()),
        "logits_scale": float(cpu["logits"].abs().max()),
        "loss_abs": abs(card["loss"] - cpu["loss"]), "loss": cpu["loss"],
        "aux_card": card["aux"], "aux_cpu": cpu["aux"],
        "dropped_card": card["dropped"], "dropped_cpu": cpu["dropped"],
        "grad_leaves": len(cpu["grads"]),
        "grad_zero_leaves": sum(float(g.abs().max()) == 0.0
                                for g in out["cpu", "float64"]["grads"]
                                .values()),
        "grad64_rel_max": g64, "grad64_rel_leaf": g64_leaf,
        "grad32_card_vs_cpu": grad_rel(card["grads"], cpu["grads"])}


def lm_launches_expected(steps: int, evals: int, flash_layers: int = 0
                         ) -> dict:
    """Every counted kernel's launches in a 2-layer language_ddp-width
    run at jit+pallas: LayerNorm 5 a forward (two per block and the
    final norm; its backward runs no kernel), the CE forward a step or
    eval batch and its backward a step, and with `flash_layers` the
    flash forward once a layer a forward, dq and dk/dv once a layer a
    step."""
    return {"flash_attention_fwd": flash_layers * (steps + evals),
            "flash_attention_dq": flash_layers * steps,
            "flash_attention_dkv": flash_layers * steps,
            "fused_rmsnorm": 0, "fused_rmsnorm_bwd": 0,
            "fused_softmax_xent_fwd": steps + evals,
            "fused_softmax_xent_bwd": steps,
            "fused_layernorm": 5 * (steps + evals), "paged_attention": 0}


def phase_train_moe(smi: str, runs: dict, steps: int = FSDP_STEPS) -> dict:
    """The MoE LM through `cli.main train --moe_experts 4 --moe_top_k 2
    --moe_every 2` at language_ddp's widths (seq 128, batch 32, bf16,
    jit+pallas), one epoch of 50 steps and the validation batches, in
    the sharded rank (world 1: the expert all-to-alls are the
    identity). The losses fall, the aux loss (the CSV's aux_loss over
    aux_weight 0.01) is finite and near 1, the share of top-k picks
    dropped for capacity is printed, and the LayerNorm and CE launches
    are exact. Then `moe_fp32_step`."""
    r = runs["moe"]
    losses = np.asarray(r["losses"])
    row = r["csv"][-1]
    aux = float(row["aux_loss"]) / 0.01
    rec = {"phase": "train_moe", "nvidia_smi": smi, "wall_s": r["wall_s"],
           "steps": len(losses), "eval_batches": r["eval_batches"],
           "experts": r["experts"], "top_k": r["top_k"],
           "moe_blocks": r["moe_blocks"], "layers": r["layers"],
           "loss_first10": float(losses[:10].mean()),
           "loss_last10": float(losses[-10:].mean()),
           "lm_loss": float(row["lm_loss"]), "aux": aux,
           "val_loss": float(row["val_loss"]),
           "dropped_share": r["dropped_share"],
           "step_ms_p50": float(np.percentile(r["step_ms"], 50))
           if r["step_ms"] else None,
           "peak_mem_gb": r["peak_mem_gb"], "launches": r["launches"],
           "launches_expected": lm_launches_expected(
               len(losses), r["eval_batches"])}
    rec["fp32_step"] = fp32 = moe_fp32_step()
    emit(rec)
    print(f"train_moe: {100 * r['dropped_share']:.2f}% of the last "
          "step's top-2 picks dropped for capacity", flush=True)
    problems = []
    if (len(losses), r["eval_batches"], r["moe_blocks"]) != (steps, 14, 1):
        problems.append(f"{len(losses)} steps, {r['eval_batches']} evals, "
                        f"{r['moe_blocks']} MoE blocks")
    if not (np.isfinite(losses).all() and rec["loss_last10"]
            < rec["loss_first10"]):
        problems.append("losses not finite or not falling")
    if not (math.isfinite(aux) and 0.9 <= aux <= 1.5):
        problems.append(f"aux {aux} not near 1")
    if r["launches"] != rec["launches_expected"]:
        problems.append(f"launch counts {r['launches']} != "
                        f"{rec['launches_expected']}")
    if not (fp32["logits_max_abs"] <= 1e-4 * fp32["logits_scale"]
            and fp32["loss_abs"] <= 1e-5 * fp32["loss"]
            and fp32["grad64_rel_max"] <= 1e-5
            and fp32["grad_zero_leaves"] == 0):
        problems.append(f"fp32 step card vs cpu {fp32}")
    if problems:
        raise AssertionError("train_moe: " + "; ".join(problems))
    return rec


def phase_train_ulysses(smi: str, runs: dict, long_rec: dict) -> dict:
    """train_long's config (seq 4096, batch 8, 30 steps and 30 eval
    batches) at `--attention-impl ulysses` in the sharded rank: at seq 1
    the all-to-alls are the identity and the local attention is the
    flash kernels' (the tier maps ulysses to "ulysses:pallas"), so the
    losses are bit-identical to the train_long run (attention "auto",
    the flash kernels, in this process), and every launch is exact."""
    r = runs["ulysses"]
    rec = {"phase": "train_ulysses", "nvidia_smi": smi, "wall_s": r["wall_s"],
           "attention_impl": r["attention_impl"], "steps": len(r["losses"]),
           "eval_batches": r["eval_batches"],
           "losses_bit_identical": r["losses"] == long_rec["losses"],
           "val_loss": r["val_loss"], "val_loss_long": long_rec["val_loss"],
           "step_ms_p50": float(np.percentile(r["step_ms"], 50)),
           "step_ms_p50_long": long_rec["step_ms_p50"],
           "peak_mem_gb": r["peak_mem_gb"], "launches": r["launches"],
           "launches_expected": lm_launches_expected(
               len(r["losses"]), r["eval_batches"], r["layers"])}
    emit(rec)
    problems = []
    if (rec["steps"], rec["eval_batches"], rec["attention_impl"]) != (
            LONG_STEPS, LONG_STEPS, "ulysses:pallas"):
        problems.append(f"{rec['steps']} steps, {rec['eval_batches']} "
                        f"evals, {rec['attention_impl']}")
    if not rec["losses_bit_identical"] \
            or rec["val_loss"] != rec["val_loss_long"]:
        problems.append("losses differ from the pallas run's")
    if r["launches"] != rec["launches_expected"]:
        problems.append(f"launch counts {r['launches']} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("train_ulysses: " + "; ".join(problems))
    return rec


RING_RTOL = 1e-4


def phase_train_ring(smi: str, runs: dict) -> dict:
    """The same config at `--attention-impl ring` and at `xla`, both
    fp32 (TF32 off), RING_STEPS steps and as many eval batches, in the
    sharded rank: every loss within RING_RTOL relative of the xla run's
    (the ring's fp32 online softmax against the dense einsum's softmax;
    the two reduce in different orders), the flash kernels launched 0
    times (the ring's inner loop is plain matmuls, as the reference's
    is XLA einsums), the LayerNorm and CE launches exact."""
    ring, xla = runs["ring"], runs["xla"]
    a, b = np.asarray(ring["losses"]), np.asarray(xla["losses"])
    rec = {"phase": "train_ring", "nvidia_smi": smi,
           "wall_s": ring["wall_s"], "xla_wall_s": xla["wall_s"],
           "dtype": ring["dtype"], "steps": len(a),
           "eval_batches": ring["eval_batches"],
           "losses": a.tolist(), "xla_losses": b.tolist(),
           "max_rel": float(np.max(np.abs(a - b) / np.abs(b))),
           "rtol": RING_RTOL,
           "val_loss": float(ring["csv"][-1]["val_loss"]),
           "xla_val_loss": float(xla["csv"][-1]["val_loss"]),
           "step_ms_p50": float(np.percentile(ring["step_ms"], 50)),
           "xla_step_ms_p50": float(np.percentile(xla["step_ms"], 50)),
           "peak_mem_gb": ring["peak_mem_gb"],
           "xla_peak_mem_gb": xla["peak_mem_gb"],
           "launches": ring["launches"], "xla_launches": xla["launches"],
           "launches_expected": lm_launches_expected(
               len(a), ring["eval_batches"])}
    emit(rec)
    problems = []
    if (len(a), ring["dtype"], ring["attention_impl"]) != (
            RING_STEPS, "float32", "ring"):
        problems.append(f"{len(a)} steps {ring['dtype']} "
                        f"{ring['attention_impl']}")
    if len(b) != len(a) or not np.isfinite(a).all() \
            or rec["max_rel"] > RING_RTOL:
        problems.append(f"ring {a} vs xla {b}")
    for name, r in (("ring", ring), ("xla", xla)):
        if r["launches"] != rec["launches_expected"]:
            problems.append(f"{name} launch counts {r['launches']} != "
                            f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("train_ring: " + "; ".join(problems))
    return rec


def phase_pipeline_lm(smi: str, runs: dict) -> dict:
    """`pipeline_lm_run`'s readings: weights equal to the TransformerLM's
    from the same init, logits bit-identical, one train step (finite
    loss, every stage leaf updated, LayerNorm 5 and CE 1 + 1
    launches)."""
    r = runs["pipeline"]
    rec = {"phase": "pipeline_lm", "nvidia_smi": smi, **r,
           "launches_expected": lm_launches_expected(1, 0)}
    emit(rec)
    problems = []
    if not (r["weights_equal"] and r["logits_bit_identical"]):
        problems.append(f"not the TransformerLM's: weights "
                        f"{r['weights_equal']}, logits max abs "
                        f"{r['logits_max_abs']}")
    if not (math.isfinite(r["step_loss"]) and r["stage_leaves_moved"]):
        problems.append(f"train step {r['step_loss']} moved "
                        f"{r['stage_leaves_moved']}")
    if r["launches"] != rec["launches_expected"]:
        problems.append(f"launch counts {r['launches']} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("pipeline_lm: " + "; ".join(problems))
    return rec


def llama_full_launches_expected(n_layers: int, steps: int,
                                 evals: int) -> dict:
    """`llama_launches_expected` for a full fine-tune: the same forward
    and attention launches, and the RMSNorm backward kernel once a step
    for every norm, the first included (the embedding trains, so the
    first norm's input needs a gradient, and every norm weight does)."""
    return llama_launches_expected(n_layers, steps, evals) | {
        "fused_rmsnorm_bwd": (2 * n_layers + 1) * steps}


def phase_llama_fsdp(smi: str, runs: dict) -> dict:
    """Llama-2-7B fsdp_bf16 under FSDP2 at world 1 (the rank's last
    run; see the module docstring)."""
    r = runs["llama"]
    losses = np.asarray(r["losses"])
    p50 = float(np.percentile(r["step_ms"], 50)) if r["step_ms"] else None
    seq = r["seq_len"]
    with open(r["csv_path"]) as f:
        rows = list(csv.reader(f))
    rec = {"phase": "llama_fsdp", "nvidia_smi": smi, "world": runs["world"],
           "params": r["params"], "param_dtype": r["param_dtype"],
           "layers": r["layers"], "d_model": r["d_model"],
           "n_params": r["n_params"], "trained_params": r["trained"],
           "seq_len": seq, "batch": 1, "losses": losses.tolist(),
           "val_loss": r["val_loss"], "step_ms": r["step_ms"],
           "step_ms_p50": p50,
           "tokens_per_s": seq / (p50 / 1e3) if p50 else None,
           "peak_mem_gb": r["peak_mem_gb"],
           "reserved_peak_gb": r["reserved_peak_gb"],
           "parent_reserved_gb": runs["parent_reserved_gb"],
           "run_wall_s": r["wall_s"], "rank_process_s": runs["process_s"],
           "csv_rows": len(rows) - 1, "launches": r["launches"],
           "launches_expected": llama_full_launches_expected(
               r["layers"], len(losses), LLAMA_FSDP_EVALS)}
    emit(rec)
    problems = []
    if runs["world"] != 1 or r["params"] != "DTensor" \
            or r["trained"] != r["n_params"]:
        problems.append(f"layout {runs['world']} {r['params']} "
                        f"{r['trained']}/{r['n_params']}")
    if r["model"] == "llama_7b" and (
            r["layers"], r["d_model"], r["param_dtype"], seq) != (
            32, 4096, "torch.bfloat16", 4096):
        problems.append("not Llama-2-7B's widths and depth in bf16 at "
                        "seq 4096")
    if len(losses) != LLAMA_FSDP_STEPS or not np.isfinite(losses).all() \
            or not np.isfinite(r["val_loss"]):
        problems.append(f"losses {losses.tolist()}, val {r['val_loss']}")
    if len(rows) != 2 or rows[1][rows[0].index("mode")] != "fsdp_bf16":
        problems.append(f"csv {rows}")
    if r["launches"] != rec["launches_expected"]:
        problems.append(f"launch counts {r['launches']} != "
                        f"{rec['launches_expected']}")
    if problems:
        raise AssertionError("llama_fsdp: " + "; ".join(problems))
    return rec


def phase_dry_init(smi: str) -> dict:
    """The `--dry-init` plan of Llama-2-7B fsdp_bf16 on an abstract
    fsdp-4 mesh, through the CLI in this process."""
    import contextlib

    from hyperion_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train", "--model", "llama", "--llama_size", "7b",
                       "--dry-init", "--mesh", "1,4,1,1"])
    line = next((x for x in buf.getvalue().splitlines()
                 if "dry-init memory plan" in x), "")
    plan = json.loads(line.split("plan: ", 1)[1]) if line else {}
    rec = {"phase": "dry_init", "nvidia_smi": smi, "rc": rc,
           "seconds": time.perf_counter() - t0, "plan": plan}
    emit(rec)
    if rc != 0 or plan.get("param_count") != 6_738_415_616 \
            or plan.get("mesh", {}).get("fsdp") != 4 \
            or not math.isclose(4 * plan["per_device_gb"], plan["total_gb"],
                                rel_tol=1e-3):
        raise AssertionError(f"dry_init: rc {rc}, plan {plan}")
    return rec


PREP_DIR = Path("build/chip_smoke_prepare")
CIFAR_DIR = Path("build/chip_smoke_cifar")
SCALING_DIR = Path("build/chip_smoke_scaling")
INFER_DIR = Path("build/chip_smoke_infer")


def _all_launch_counts() -> dict:
    """Every kernel wrapper's launch count: the training paths' and
    LayerNorm's and paged attention's, to show a path that runs none."""
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
    from hyperion_tpu_torch.ops.paged_attention import paged_attention

    return {**_launch_counts(), "fused_layernorm": fused_layernorm.launches,
            "paged_attention": paged_attention.launches}


def _zero_all_launches() -> None:
    from hyperion_tpu_torch.ops.fused_norm import fused_layernorm
    from hyperion_tpu_torch.ops.paged_attention import paged_attention

    _reset_launch_counts()
    fused_layernorm.launches = paged_attention.launches = 0


def phase_prepare(smi: str) -> dict:
    """`python -m hyperion_tpu_torch.data.prepare` twice into PREP_DIR:
    `--cifar` (the synthetic source: 5000 train and 1000 test images;
    the repo holds no CIFAR pickles) writes the recordio splits the
    cifar phase trains on, and `--input` on a seeded corpus (the route
    phase's text, 500 lines) with a 300-token tokenizer writes a text
    split that `load_wikitext2` reads back from recordio. Both end in
    their reload-verify."""
    import shutil

    from hyperion_tpu_torch.data.recordio import RecordFile
    from hyperion_tpu_torch.data.text import load_wikitext2

    shutil.rmtree(PREP_DIR, ignore_errors=True)
    PREP_DIR.mkdir(parents=True)
    corpus = PREP_DIR / "corpus.txt"
    corpus.write_text("\n".join(route_corpus(np.random.default_rng(SEED))
                                [:500]))
    mod = [sys.executable, "-m", "hyperion_tpu_torch.data.prepare",
           "--base-dir", str(PREP_DIR)]
    cifar = _run([*mod, "--cifar"], 300)
    text = _run([*mod, "--input", str(corpus), "--vocab-size", "300"], 300)
    rec: dict = {"phase": "prepare", "nvidia_smi": smi,
                 "cifar_rc": cifar["rc"], "cifar_s": cifar["seconds"],
                 "text_rc": text["rc"], "text_s": text["seconds"]}
    rio = PREP_DIR / "cifar10_prepared"
    rec["cifar_files"] = sorted(p.name for p in rio.glob("*.rio"))
    for split in ("train", "test"):
        with RecordFile(rio / f"{split}.images.rio") as f:
            rec[f"cifar_{split}_images"] = len(f)
    got = load_wikitext2(PREP_DIR, splits=("train",))["train"]
    rec.update(text_source=got.source, text_rows=len(got),
               meta=json.loads((PREP_DIR / "wikitext2_tokenized" /
                                "prepare_meta.json").read_text()))
    emit(rec)
    problems = []
    for name, run in (("cifar", cifar), ("text", text)):
        if run["rc"] != 0 or "reload-verify OK" not in run["log"]:
            problems.append(f"{name}: rc {run['rc']}: {run['log'][-800:]}")
    if rec["cifar_files"] != ["test.images.rio", "test.labels.rio",
                              "train.images.rio", "train.labels.rio"] \
            or rec["cifar_train_images"] != 5000 \
            or rec["cifar_test_images"] != 1000:
        problems.append(f"cifar files {rec}")
    if not got.source.startswith("recordio") or len(got) != 500:
        problems.append(f"text split {got.source}, {len(got)} rows")
    if problems:
        raise AssertionError("prepare: " + "; ".join(problems))
    return rec


def cifar_fp32_step(seed: int = SEED) -> dict:
    """One fp32 cifar step (ResNet-18, batch 64 of the prepared split,
    AdamW at the job's 1e-3) from the same weights (the seeded init with
    each block's last BatchNorm scale 1, not 0, so that every leaf has
    a gradient) on the card (cuDNN, TF32 off) and on the CPU (the
    plain path): the largest differences of the train-mode logits, the
    loss, the BatchNorm running statistics and the parameters after the
    update (a reading only: AdamW's first step moves an element by lr
    whatever its gradient's size, so a rounding-noise gradient that
    flips sign moves it 2 lr apart).

    The backward (cuDNN's convolution backward in channels_last,
    BatchNorm's in plain ops) is held per leaf in float64, the same
    model and batch on both sides: fp32 gradients of this network carry
    rounding errors of a few percent of a leaf's largest gradient on
    either device (the readings `grad32_*` against float64 show it), so
    they cannot tell a wrong gradient from rounding; float64's are
    ~1e-16 relative before the same amplification."""
    from hyperion_tpu_torch.data.vision import load_cifar10
    from hyperion_tpu_torch.models.resnet import BatchNorm, resnet18
    from hyperion_tpu_torch.train.losses import classification_loss
    from hyperion_tpu_torch.train.state import make_optimizer
    from hyperion_tpu_torch.train.trainer import nchw

    assert not torch.backends.cudnn.allow_tf32  # main() turns TF32 off
    split = load_cifar10(PREP_DIR)["train"]
    images = torch.from_numpy(split.images[:64])
    labels = torch.from_numpy(split.labels[:64])
    out = {}
    ref = resnet18(device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    for mod in ref.modules():
        if isinstance(mod, BatchNorm) and mod.zero_scale:
            mod.weight.data.fill_(1.0)
    for dtype in ("float32", "float64"):
        for dev in ("cuda", "cpu"):
            model = resnet18(device=dev, dtype=dtype)
            model.load_state_dict(ref.state_dict())
            model.to(getattr(torch, dtype))
            if dev == "cuda":
                model.to(memory_format=torch.channels_last)
            opt = make_optimizer(model.parameters(), 1e-3)
            x = nchw(images.to(dev)).to(getattr(torch, dtype))
            logits = model(x, train=True)
            if dtype == "float32":  # the job's loss, in fp32
                loss, _ = classification_loss(logits, labels.to(dev))
            else:  # its CE, in float64 too
                loss = torch.nn.functional.cross_entropy(
                    logits, labels.to(dev).long())
            loss.backward()
            grads = {k: p.grad.detach().cpu().double()
                     for k, p in model.named_parameters()}
            opt.step()
            out[dev, dtype] = {
                "logits": logits.detach().cpu(), "loss": loss.detach().cpu(),
                "grads": grads, "state": {
                    k: v.detach().cpu() for k, v in model.state_dict().items()}}
    card, cpu = out["cuda", "float32"], out["cpu", "float32"]
    truth = out["cpu", "float64"]["grads"]

    def grad_rel(a: dict, b: dict) -> tuple[float, str]:
        """The largest over leaves of max|a - b| / max|b|, and its leaf."""
        rel = {k: float((a[k] - g).abs().max())
               / max(float(g.abs().max()), 1e-300) for k, g in b.items()}
        leaf = max(rel, key=rel.get)
        return rel[leaf], leaf

    g64, g64_leaf = grad_rel(out["cuda", "float64"]["grads"], truth)

    def worst(keys):
        return max(float((card["state"][k] - cpu["state"][k]).abs().max())
                   for k in keys)

    stats = [k for k in cpu["state"] if k.endswith(("running_mean",
                                                    "running_var"))]
    return {
        "tf32": False,
        "logits_max_abs": float((card["logits"] - cpu["logits"]).abs().max()),
        "logits_scale": float(cpu["logits"].abs().max()),
        "loss_abs": float((card["loss"] - cpu["loss"]).abs()),
        "loss": float(cpu["loss"]),
        "grad_leaves": len(truth),
        "grad_zero_leaves": sum(float(g.abs().max()) == 0.0
                                for g in truth.values()),
        "grad64_rel_max": g64, "grad64_rel_leaf": g64_leaf,
        "grad32_card_vs_cpu": grad_rel(card["grads"], cpu["grads"]),
        "grad32_cpu_vs_fp64": grad_rel(cpu["grads"], truth),
        "grad32_card_vs_fp64": grad_rel(card["grads"], truth),
        "params_max_abs": worst([k for k in cpu["state"] if k not in stats]),
        "stats_max_abs": worst(stats),
        "stats_scale": max(float(cpu["state"][k].abs().max())
                           for k in stats)}


def phase_cifar(smi: str) -> dict:
    """`cli.main train --model cifar` on the card, in this process:
    ResNet-18 at its published widths (CIFAR stem, 11.2M parameters)
    under the default bf16 policy, batch 64, lr 1e-3, 2 epochs over the
    prepare phase's recordio split (5000 train, 1000 test images; 78
    steps an epoch, 15 validation batches). Then `cifar_fp32_step`."""
    import shutil

    from hyperion_tpu_torch.cli import main as cli
    from hyperion_tpu_torch.data.vision import load_cifar10

    shutil.rmtree(CIFAR_DIR, ignore_errors=True)
    results = []
    run_job = cli.run_job
    cli.run_job = lambda args, job: results.append(run_job(args, job)) \
        or results[-1]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_all_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["train", "--model", "cifar", "--epochs", "2",
                       "--base_dir", str(CIFAR_DIR),
                       "--data_dir", str(PREP_DIR)])
    finally:
        cli.run_job = run_job
    wall = time.perf_counter() - t0
    launches = _all_launch_counts()
    (res,) = results
    losses = np.asarray(res.step_losses)
    step_ms = np.asarray(res.step_ms)
    p50 = float(np.percentile(step_ms, 50))
    with open(res.csv_path) as f:
        rows = list(csv.DictReader(f))
    with open(CIFAR_DIR / "distributed" / "scaling_analysis.csv") as f:
        report = list(csv.DictReader(f))
    gauges = gauge_readings(res)
    gauges["samples_per_s"] = res.metrics.get("gauges", {}).get(
        "samples_per_s")
    rec = {"phase": "cifar", "nvidia_smi": smi, "rc": rc, "wall_s": wall,
           "steps": len(losses), "epoch_loss": [h.loss for h in res.history],
           "accuracy": [h.extra["accuracy"] for h in res.history],
           "val_loss": [h.extra["val_loss"] for h in res.history],
           "val_accuracy": [h.extra["val_accuracy"] for h in res.history],
           "epoch_s": [h.duration_s for h in res.history],
           "step_ms_p50": p50, "step_ms_min": float(step_ms.min()),
           "step_ms_max": float(step_ms.max()),
           "images_per_s": 64 / (p50 / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": sum(p.numel() for p in res.model.parameters()),
           "source": load_cifar10(PREP_DIR)["train"].source,
           "csv_header": list(rows[0]),
           "report": report, "launches": launches,
           "checkpoint": ckpt_readings(CIFAR_DIR, "cifar_ddp_1dev"),
           "gauges": gauges}
    del res, results
    gc.collect()
    rec["fp32_step"] = fp32 = cifar_fp32_step()
    emit(rec)
    problems = train_problems("cifar", rec["checkpoint"], gauges)
    if not rec["source"].startswith("recordio:"):
        problems.append(f"trained on {rec['source']}, not the prepared split")
    if rc != 0 or rec["steps"] != 2 * 78 or rec["params"] != 11_173_962:
        problems.append(f"rc {rc}, {rec['steps']} steps, {rec['params']} "
                        "params")
    if not (np.isfinite(losses).all()
            and all(np.isfinite(rec["val_loss"]))):
        problems.append("non-finite loss")
    if not rec["epoch_loss"][1] < rec["epoch_loss"][0]:
        problems.append(f"loss did not fall: {rec['epoch_loss']}")
    if not rec["val_accuracy"][-1] > 10.0:
        problems.append(f"validation accuracy {rec['val_accuracy']} at "
                        "chance")
    if rec["csv_header"] != ["epoch", "loss", "accuracy", "duration_s",
                             "gpus", "val_loss", "val_accuracy"]:
        problems.append(f"csv header {rec['csv_header']}")
    if [(r["model"], r["gpus"]) for r in report] != [("cifar_ddp", "1")]:
        problems.append(f"scaling report {report}")
    if any(launches.values()):
        problems.append(f"a hand kernel ran on the cifar path: {launches}")
    # fp32, TF32 off: cuDNN's and the CPU's convolutions sum in other
    # orders: 1e-4 of the logits' scale and of the statistics' scale,
    # 1e-5 relative loss; the gradients in float64, 1e-6 of each leaf's
    # largest, every leaf with a gradient
    if not (fp32["logits_max_abs"] <= 1e-4 * fp32["logits_scale"]
            and fp32["loss_abs"] <= 1e-5 * fp32["loss"]
            and fp32["grad64_rel_max"] <= 1e-6
            and fp32["grad_zero_leaves"] == 0
            and fp32["stats_max_abs"] <= 1e-4 * fp32["stats_scale"]):
        problems.append(f"fp32 step card vs cpu {fp32}")
    if problems:
        raise AssertionError("cifar: " + "; ".join(problems))
    return rec


def phase_scaling(smi: str) -> dict:
    """The sweep as a user starts it, `cli.main train --model scaling`
    at the default `--device cuda` (`run_scaling_experiment(
    device_counts=[1], models=["cifar"], simulate_on_cpu=False,
    epochs=1, steps_per_epoch=10)`): one `torchrun --nproc-per-node 1`
    run of the cifar job on the card (NCCL, the synthetic split) and
    the report over it."""
    import shutil

    from hyperion_tpu_torch.cli import main as cli

    shutil.rmtree(SCALING_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    rc = cli.main(["train", "--model", "scaling", "--scaling_devices", "1",
                   "--scaling_jobs", "cifar", "--epochs", "1",
                   "--steps-per-epoch", "10", "--base_dir", str(SCALING_DIR)])
    with open(SCALING_DIR / "distributed" / "scaling_analysis.csv") as f:
        report = list(csv.DictReader(f))
    rec = {"phase": "scaling", "nvidia_smi": smi, "rc": rc,
           "seconds": time.perf_counter() - t0, "report_csv": report,
           "runs": sorted(p.name for p in (SCALING_DIR / "distributed")
                          .glob("*_metrics.csv"))}
    emit(rec)
    if [(r["model"], r["gpus"], r["speedup"]) for r in report] != \
            [("cifar_ddp", "1", "1.0")] or len(rec["runs"]) != 1 or rc != 0:
        raise AssertionError(f"scaling: rc {rc}, report {report}, runs "
                             f"{rec['runs']}")
    return rec


def infer_tokenizer(vocab_size: int = 31_000):
    """The infer phase's tokenizer: BPE trained here on the route
    phase's text (300 tokens), then grown with merges of printable
    characters (pairs, then triples) to `vocab_size`, below both
    models' vocabularies, so that nearly every id a random-weight model
    emits decodes to text the check can see."""
    from hyperion_tpu_torch.data.bpe import ByteBPE, train_bpe

    base = train_bpe(route_corpus(np.random.default_rng(SEED + 1))[:500],
                     vocab_size=300)
    vocab, merges = dict(base.vocab), list(base.merges)
    chars = [chr(c) for c in range(33, 127)]
    level = chars
    while len(vocab) < vocab_size:
        grown = []
        for a in level:
            for b in chars:
                if a + b not in vocab and len(vocab) < vocab_size:
                    vocab[a + b] = len(vocab)
                    merges.append((a, b))
                    grown.append(a + b)
        level = grown
    return ByteBPE(vocab, merges)


def _infer_cli(ckpt: Path, tok_dir: Path, prompt: str, *extra: str):
    """Start the CLI; the returned function waits for it and gives its
    stdout as bytes (the text may hold any character), its one trailing
    newline dropped."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperion_tpu_torch.infer", "--ckpt",
         str(ckpt), "--tokenizer-dir", str(tok_dir), "--prompt", prompt,
         "--max-new-tokens", "32", "--temperature", "0", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=Path(__file__).resolve().parent)

    def finish() -> dict:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        return {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                "out": out.removesuffix(b"\n"),
                "stderr": err[-800:].decode(errors="replace")}

    finish.proc = proc
    return finish


def phase_infer(smi: str) -> dict:
    """`python -m hyperion_tpu_torch.infer` on the card, temperature 0,
    32 new tokens, with `infer_tokenizer` (31,000 tokens, below both
    models' vocabularies): on the train phase's language_ddp export
    (a TransformerLM: `generate_recompute`) and on the crash phase's
    2-layer Llama-2-7B-width export (`generate`, bf16 as the loader
    gives), each also with `--quant int8` (the int8 model quantized on
    the card from the export's fp32 kernels). Each printed text must
    equal, byte for byte, an in-process decode of the same weights on
    the card, and show most of its 32 tokens; the float decodes launch
    no hand kernel, the int8 ones launch the int8 product and the row
    quantizer once a dense layer a forward (13 a forward for the 2-layer
    TransformerLM, 15 for the 2-layer Llama) and nothing else. The four
    CLI processes run at once, beside the in-process decodes."""
    from hyperion_tpu_torch.checkpoint.io import load_gathered
    from hyperion_tpu_torch.infer.generate import (
        generate,
        generate_recompute,
        model_from_npz,
    )
    from hyperion_tpu_torch.ops import int8_matmul as im

    INFER_DIR.mkdir(parents=True, exist_ok=True)
    tok = infer_tokenizer()
    tok.save(INFER_DIR / "tok")
    prompt = "the model serves tokens over a socket"
    ids = [tok.encode(prompt)]
    rec: dict = {"phase": "infer", "nvidia_smi": smi,
                 "prompt_tokens": len(ids[0])}
    problems = []
    lm_npz = Path("build/chip_smoke_train/checkpoints/language_ddp_final.npz")
    cases = (("language_ddp", lm_npz, generate_recompute, (), 2 * 6 + 1),
             ("llama", CRASH_DIR / "llama.npz", generate,
              ("--max-len", "256"), 2 * 7 + 1))
    runs = [(c, q) for c in cases for q in ("none", "int8")]
    clis = [_infer_cli(npz, INFER_DIR / "tok", prompt, *extra, "--quant", q)
            for (_, npz, _, extra, _), q in runs]
    try:
        for ((name, npz, decode, extra, denses), quant), finish in zip(runs,
                                                                      clis):
            key = name if quant == "none" else f"{name}_int8"
            t0 = time.perf_counter()
            model, cached = model_from_npz(load_gathered(npz), 256,
                                           device="cuda", quant=quant)
            _zero_all_launches()
            im.int8_matmul.launches = im.quantize_rows.launches = 0
            out = decode(model, ids, 32, eos_id=tok.eos_id, pad_id=tok.eos_id)
            launches = {**_all_launch_counts(),
                        "int8_matmul": im.int8_matmul.launches,
                        "quantize_rows": im.quantize_rows.launches}
            new = [int(t) for t in out[0].tolist() if t != tok.eos_id]
            want = (prompt + tok.decode(new)).encode()
            visible = sum(t in tok.id_to_token for t in new)
            in_process_s = time.perf_counter() - t0
            cli = finish()
            rec[key] = {"cli_rc": cli["rc"], "cli_s": cli["seconds"],
                        "cached": cached, "ids": new, "visible": visible,
                        "text": want.decode(), "in_process_s": in_process_s,
                        "equal": cli["out"] == want, "launches": launches}
            if cli["rc"] != 0 or cli["out"] != want:
                problems.append(f"{key}: rc {cli['rc']}, cli {cli['out']!r} "
                                f"!= in-process {want!r}; {cli['stderr']}")
            if visible < 16:
                problems.append(f"{key}: {visible} of 32 tokens decode")
            # generate: a prefill of the prompt's rows, then one row a step;
            # generate_recompute: every step a forward of the whole buffer
            rows = ([len(ids[0])] + [1] * 31 if cached
                    else [len(ids[0]) + 32] * 32)
            want = {"int8_matmul": 32 * denses,
                    "quantize_rows": denses * sum(r > 16 for r in rows)} \
                if quant == "int8" else {"int8_matmul": 0, "quantize_rows": 0}
            if cached != (name == "llama") or launches != {
                    **{k: 0 for k in launches}, **want}:
                problems.append(f"{key}: cached {cached}, launches {launches}")
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:  # a raise above leaves no CLI process running
        for finish in clis:
            if finish.proc.poll() is None:
                finish.proc.kill()
                finish.proc.wait()
    emit(rec)
    if problems:
        raise AssertionError("infer: " + "; ".join(problems))
    return rec


# ------------------------------------------------- weight-only int8

# the 7B int8 product's cases: (name, M, K, N, path, timed). Decode M = 4
# at every projection width (q/k/v/o, gate/up, down, lm_head) through the
# fused kernel from bf16 rows, the prefill of 4 prompts of 128 tokens
# (M = 512) at gate/up on wgmma, ragged M, the cluster product on
# quantized rows, and K off the 16-byte grid (byte loads)
INT8_CASES = (
    ("decode_qkvo_4x4096x4096", 4, 4096, 4096, "decode_fused", True),
    ("decode_gate_up_4x4096x11008", 4, 4096, 11008, "decode_fused", True),
    ("decode_down_4x11008x4096", 4, 11008, 4096, "decode_fused", True),
    ("decode_lm_head_4x4096x32000", 4, 4096, 32000, "decode_fused", True),
    ("prefill_gate_up_512x4096x11008", 512, 4096, 11008, "prefill_wgmma",
     True),
    ("ragged_1x4096x4096", 1, 4096, 4096, "decode_fused", False),
    ("ragged_3x4096x4096", 3, 4096, 4096, "decode_fused", False),
    ("ragged_17x4096x4096", 17, 4096, 4096, "prefill_wgmma", False),
    ("quantized_4x11008x4096", 4, 11008, 4096, "decode", False),
    ("bytes_9x4100x500", 9, 4100, 500, "bytes", True))
# timed cases off the int8 run's path (operands TMA cannot take, rows
# the one-pass quantizer cannot): their records print, and stay out of
# the `kernels` line, which holds the run's own shapes
INT8_OFF_PATH = ("bytes_9x4100x500", "fp32_3x1001", "bf16_2x4100")


@contextlib.contextmanager
def plain_int8():
    """The int8 layers (`precision.quant`) on the kernels' plain versions,
    on the card: what the kernel path is held to, bit for bit."""
    from hyperion_tpu_torch.ops import int8_matmul as im
    from hyperion_tpu_torch.precision import quant as tq

    saved = tq.quantize_rows, tq._int8_matmul, tq._dense_decode
    tq.quantize_rows, tq._int8_matmul, tq._dense_decode = (
        im.quantize_rows_plain, im.int8_matmul_plain,
        im.quantized_dense_decode_plain)
    try:
        yield
    finally:
        tq.quantize_rows, tq._int8_matmul, tq._dense_decode = saved


def check_quantize_rows(name, x, timing: bool) -> dict:
    """The per-row quantizer against its plain version (q and scale bit
    for bit, a rerun the same)."""
    from hyperion_tpu_torch.ops import int8_matmul as im

    q, s = im.quantize_rows(x)
    q2, s2 = im.quantize_rows(x)
    pq, ps = im.quantize_rows_plain(x)
    torch.cuda.synchronize()
    path = im.quantize_rows_path(x)
    ok = all(torch.equal(a, b) for a, b in ((q, pq), (s, ps), (q, q2),
                                             (s, s2))) and \
        im.c_paths(x, torch.empty(1, x.shape[-1], dtype=torch.int8,
                                  device="cuda"))[1] == path
    rec = {"phase": "kernels", "kernel": "quantize_rows", "case": name,
           "dtype": str(x.dtype).split(".")[-1], "shape": list(x.shape),
           "path": path,
           "max_abs_err": float((q.int() - pq.int()).abs().max()),
           "tol": "bit-identical", "ok": ok,
           **im.kernel_attrs("quantize_" + path, x.dtype)}
    if timing:
        rows = x.numel() // x.shape[-1]
        nbytes = x.numel() * (x.element_size() + 1) + 4 * rows
        rec["kernel_ms"] = time_ms(im.quantize_rows, (x,), nbytes)
        rec["plain_ms"] = time_ms(im.quantize_rows_plain, (x,), nbytes)
        # ~3 fp32 operations an element (abs-max, divide, round) on the
        # CUDA cores, 66.9 TFLOP/s
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3.0 * x.numel() / 66.9e12
        rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["library_ms"] = None  # no one PyTorch call quantizes
    emit(rec)
    if not ok:
        raise AssertionError(f"quantize_rows {name}: the kernel's q or scale "
                             "differ from the plain version's")
    return rec


def check_int8_matmul(name, M, K, N, want, seed, timing: bool) -> dict:
    """An int8 product against its plain version at a 7B shape, on the
    path `want`: "decode_fused" from seeded bf16 rows through
    `quantized_dense_decode` (the rows quantized inside the product),
    the others on rows quantized first through `int8_matmul`; weights
    quantized from seeded bf16, bf16 out, bit for bit and a rerun the
    same, the Python and C path rules agreeing; its kernel's registers,
    spills, shared memory and cluster; kernel, plain, bound, library
    (`torch._int_mm` and the same epilogue, where it takes M > 16) and
    bf16 `F.linear` times."""
    from hyperion_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(N, K, generator=g, device="cuda")).to(
        torch.bfloat16)
    wq, sw = im.quantize_rows(w)
    if want == "decode_fused":
        args = (x, wq, sw)
        fn = lambda *a: im.quantized_dense_decode(*a, torch.bfloat16)
        plain = lambda *a: im.quantized_dense_decode_plain(*a, torch.bfloat16)
        nbytes = K * N + 2 * M * K + 2 * M * N + 4 * N
    else:
        xq, sx = im.quantize_rows(x)
        if want == "bytes":  # an operand one byte off the 16-byte grid
            view = torch.empty(xq.numel() + 1, dtype=torch.int8,
                               device="cuda")[1:].view_as(xq)
            xq = view.copy_(xq)
        args = (xq, wq, sx, sw)
        fn = lambda *a: im.int8_matmul(*a, torch.bfloat16)
        plain = lambda *a: im.int8_matmul_plain(*a, torch.bfloat16)
        nbytes = K * N + M * K + 2 * M * N + 4 * (M + N)
    out, again, ref = fn(*args), fn(*args), plain(*args)
    torch.cuda.synchronize()
    path = im.int8_matmul_path(args[0], wq)
    ok = torch.equal(out, ref) and torch.equal(out, again) and \
        path == want == im.c_paths(args[0], wq)[0]
    rec = {"phase": "kernels", "kernel": "int8_matmul", "case": name,
           "dtype": f"{args[0].dtype}->bfloat16".replace("torch.", ""),
           "shape": [M, K, N], "path": path,
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "tol": "bit-identical", "ok": ok,
           **im.kernel_attrs(want, args[0].dtype if want == "decode_fused"
                             else torch.bfloat16, K, N)}
    if timing:
        rec["kernel_ms"] = time_ms(fn, args, nbytes)
        rec["plain_ms"] = time_ms(plain, args, nbytes)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * N * K,
                                                 torch.int8)
        rec["library_ms"] = time_ms(
            lambda a, b, c, d: (torch._int_mm(a, b.t()).float() * c[:, None]
                                * d[None, :]).to(torch.bfloat16),
            args, nbytes) if M > 16 else None
        rec["bf16_linear_ms"] = time_ms(torch.nn.functional.linear, (x, w),
                                        2 * (M * K + N * K + M * N))
    emit(rec)
    if not ok:
        raise AssertionError(f"int8_matmul {name}: kernel differs from the "
                             f"plain version ({rec['max_abs_err']}), a "
                             f"rerun differs, or the {path} kernel ran "
                             f"instead of {want}")
    return rec


def phase_int8_kernels() -> dict:
    """Both int8 kernels at the 7B shapes, and the byte-load product and
    scalar quantizer off the grid; returns the timed records of the
    run's shapes for the `kernels` line."""
    recs = {"int8_matmul": [], "quantize_rows": []}
    for i, (name, M, K, N, path, timing) in enumerate(INT8_CASES):
        rec = check_int8_matmul(name, M, K, N, path, SEED + 50 + i, timing)
        if timing and name not in INT8_OFF_PATH:
            recs["int8_matmul"].append(rec)
    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    for name, shape, dtype, timing in (
            ("decode_4x4096", (4, 4096), torch.bfloat16, True),
            ("decode_down_4x11008", (4, 11008), torch.bfloat16, True),
            ("prefill_512x4096", (512, 4096), torch.bfloat16, True),
            ("weight_11008x4096", (11008, 4096), torch.bfloat16, True),
            ("fp32_3x1001", (3, 1001), torch.float32, True),
            ("fp16_17x4096", (17, 4096), torch.float16, False),
            ("bf16_2x4100", (2, 4100), torch.bfloat16, True)):
        x = (3 * torch.randn(*shape, generator=g, device="cuda")).to(dtype)
        x[0] = 0  # an all-zero row
        rec = check_quantize_rows(name, x, timing)
        if timing and name not in INT8_OFF_PATH:
            recs["quantize_rows"].append(rec)
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def _decode_s(model, ids, n: int) -> float:
    from hyperion_tpu_torch.infer.generate import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, ids, n, device="cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def decode_tokens_per_s(model, ids) -> float:
    """Decode tokens/s at this batch, prefill taken out: generate's wall
    time for 32 new tokens less its time for 1 (the prefill), over 31
    steps, the best of two."""
    _decode_s(model, ids, 2)  # warm
    best = min(_decode_s(model, ids, 32) - _decode_s(model, ids, 1)
               for _ in range(2))
    return len(ids) * 31 / best


def int8_dense_sum(model, qmodel, turns: int = 2) -> dict:
    """The 225 denses of one batch-4 decode forward on the models'
    weights, each way captured in one CUDA graph: this checkout's
    `quantized_dense`, the previous kernels' (quantize, then the
    product), and bf16 `F.linear` on the float weights; ms a forward,
    in turns (previous first and last), the int8 outputs checked
    bit-identical between the two first."""
    from hyperion_tpu_torch.precision.quant import QuantDense

    floats = dict(model.named_modules())
    denses = [(m.weight_q, m.weight_scale, floats[name].weight, m.bias)
              for name, m in qmodel.named_modules()
              if isinstance(m, QuantDense)]
    base = BASELINE.get("int8") or int8_profile().Baseline()
    return int8_profile().forward_turns(denses, base.load(), turns)


def phase_int8(model, smi: str) -> dict:
    """Weight-only int8 at Llama-2-7B's full widths and depth: the serve
    phase's bf16 model (fused RMSNorm) quantized on the card
    (`quantize_llama`: one `quantize_rows` launch a weight, 225), three
    kernels' weights bit-identical to the plain quantizer's, then
    `generate` at temperature 0 on two 128-token prompts alone (batch 1)
    and with two more (batch 4), 32 new tokens each: every stream and
    the prefill logits bit-identical to the same model on the plain
    versions, launches exact (32 forwards of 225 int8 products and 65
    RMSNorms, 225 row quantizations: the prefill's; a decode step's
    denses quantize inside the product). Readings: the int8-vs-bf16
    prefill logits' relative L2, decode tokens/s of both at batch 1 and
    4, the weight bytes, the allocator's peak, and a batch-4 decode
    forward's 225 denses against the previous kernels and bf16 in turns
    (`int8_dense_sum`)."""
    from hyperion_tpu_torch.infer.generate import generate
    from hyperion_tpu_torch.models.llama import init_cache
    from hyperion_tpu_torch.ops import int8_matmul as im
    from hyperion_tpu_torch.ops.fused_norm import fused_rmsnorm
    from hyperion_tpu_torch.precision.quant import quantize_llama

    cfg = model.cfg
    per_fwd = 7 * cfg.n_layers + 1
    problems = []
    gc.collect()
    torch.cuda.synchronize()
    im.quantize_rows.launches = im.int8_matmul.launches = 0
    t0 = time.perf_counter()
    qmodel, qstate = quantize_llama(model, cfg)
    torch.cuda.synchronize()
    rec = {"phase": "int8", "nvidia_smi": smi, "layers": cfg.n_layers,
           "quantize_s": time.perf_counter() - t0,
           "quantize_launches": im.quantize_rows.launches}
    if rec["quantize_launches"] != per_fwd:
        problems.append(f"{rec['quantize_launches']} weight quantizations, "
                        f"want {per_fwd}")
    fstate = model.state_dict()
    for name in ("layers.0.attn.q_proj", "layers.0.mlp.down_proj",
                 "lm_head"):
        q, sc = im.quantize_rows_plain(fstate[name + ".weight"])
        if not (torch.equal(q, qstate[name + ".weight_q"])
                and torch.equal(sc, qstate[name + ".weight_scale"])):
            problems.append(f"{name}: card quantization differs from plain")
    # one layer's error alone: q_proj of layer 0 on seeded bf16 rows,
    # int8 against bf16
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x = torch.randn(4, cfg.d_model, generator=g, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        a = qmodel.layers[0].attn.q_proj(x).float()
        b = model.layers[0].attn.q_proj(x).float()
    rec["layer0_q_proj_rel_l2"] = float(torch.linalg.vector_norm(a - b)
                                        / torch.linalg.vector_norm(b))
    rec["weight_bytes"] = {
        "int8": sum(t.numel() * t.element_size() for t in qstate.values()),
        "bf16": sum(t.numel() * t.element_size() for t in fstate.values())}
    del fstate, qstate

    prompts = np.random.default_rng(SEED + 30).integers(
        1, cfg.vocab_size, (4, 128))
    runs = {"b1_a": prompts[:1], "b1_b": prompts[1:2], "b4": prompts}

    def prefill_logits(m, ids):
        with torch.no_grad():
            out, _ = m(torch.as_tensor(ids, device="cuda"),
                       cache=init_cache(m.cfg, len(ids), 128, device="cuda"),
                       cache_index=0)
        return out

    streams, launches = {}, {}
    for run, ids in runs.items():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        im.quantize_rows.launches = im.int8_matmul.launches = 0
        fused_rmsnorm.launches = 0
        out = generate(qmodel, ids, 32, device="cuda").cpu()
        torch.cuda.synchronize()
        launches[run] = {"int8_matmul": im.int8_matmul.launches,
                         "quantize_rows": im.quantize_rows.launches,
                         "fused_rmsnorm": fused_rmsnorm.launches}
        # 32 forwards of 225 products; rows quantized apart from the
        # product in the 128-row prefill alone
        want = {"int8_matmul": 32 * per_fwd, "quantize_rows": per_fwd,
                "fused_rmsnorm": 32 * (2 * cfg.n_layers + 1)}
        if launches[run] != want:
            problems.append(f"{run}: launches {launches[run]} != {want}")
        if run == "b4":
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with plain_int8():
            plain = generate(qmodel, ids, 32, device="cuda").cpu()
        streams[run] = out.tolist()
        if not torch.equal(out, plain):
            problems.append(f"{run}: kernel stream {out.tolist()} != plain "
                            f"{plain.tolist()}")
    if streams["b4"][:2] != streams["b1_a"] + streams["b1_b"]:
        rec["batch_rows_differ"] = True  # a reading: batch changes M
    logits = prefill_logits(qmodel, prompts)
    with plain_int8():
        plain_logits = prefill_logits(qmodel, prompts)
    rec["prefill_logits_bit_identical"] = torch.equal(logits, plain_logits)
    if not rec["prefill_logits_bit_identical"]:
        problems.append("prefill logits: kernel path != plain path")
    ref = prefill_logits(model, prompts)
    rec["int8_vs_bf16_logit_rel_l2"] = float(
        torch.linalg.vector_norm(logits - ref)
        / torch.linalg.vector_norm(ref))
    rec["greedy_agreement_with_bf16_b4"] = float(
        (generate(model, prompts, 32, device="cuda").cpu()
         == torch.tensor(streams["b4"])).float().mean())
    del logits, plain_logits, ref
    rec["decode_tokens_per_s"] = {
        f"{kind}_b{len(ids)}": decode_tokens_per_s(m, ids)
        for kind, m in (("int8", qmodel), ("bf16", model))
        for ids in (prompts[:1], prompts)}
    rec["forward_denses_ms"] = int8_dense_sum(model, qmodel)
    rec.update(streams=streams, launches=launches["b4"],
               launches_by_run=launches, finite=all(
                   0 <= t < cfg.vocab_size for row in streams["b4"]
                   for t in row))
    emit(rec)
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("int8: " + "; ".join(problems))
    return rec


# ------------------------------------------------------ Phase-1 tools


def _csv_dicts(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _finite(row: dict, *keys: str) -> bool:
    try:
        return all(math.isfinite(float(row[k])) for k in keys)
    except (KeyError, ValueError):
        return False


def phase_phase1(smi: str) -> dict:
    """The reference's Phase-1 tools, each `python -m
    hyperion_tpu_torch.bench.<name>` through its `main(argv)` into a
    temporary directory: hw_explore at 4096 and 8192 for all four dtypes
    and bandwidth at 100M and 500M elements; baseline with its four
    models at batch 32 bf16; attention_bench at seq 1024-8192, both
    impls, both modes, both geometries; compile_bench with all tiers and
    the train step; decode_bench on tiny and mid, float and int8. Every
    expected row finite (or the reference's "oom"), and no rate above
    105 % of `utils/chips.py`'s peak (bandwidth: of 3.35 TB/s)."""
    import shutil
    import tempfile

    from hyperion_tpu_torch.bench import (
        attention_bench,
        baseline,
        compile_bench,
        decode_bench,
        hw_explore,
    )

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_phase1_"))
    rec: dict = {"phase": "phase1", "nvidia_smi": smi, "seconds": {}}
    problems = []

    def timed(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = fn()
        rec["seconds"][name] = time.perf_counter() - t0
        return out

    try:
        hw = root / "hw"
        timed("hw_explore", lambda: hw_explore.main([
            "--sizes", "4096", "8192", "--bandwidth-elems", "100000000",
            "500000000", "--out", str(hw)]))
        mm = _csv_dicts(hw / "precision_results.csv")
        bw = _csv_dicts(hw / "bandwidth_results.csv")
        rec["matmul_tflops"] = {f"{r['dtype']}_{r['size']}": float(r["tflops"])
                                for r in mm}
        rec["bandwidth_gb_per_s"] = {r["elements"]: float(r["gb_per_s"])
                                     for r in bw}
        if len(mm) != 8 or len(bw) != 2:
            problems.append(f"hw_explore rows {len(mm)}, {len(bw)}")
        for r in mm:
            peak = float(r["peak_tflops"] or "nan")
            if not _finite(r, "tflops") or not float(r["tflops"]) > 0 \
                    or not float(r["tflops"]) <= 1.05 * peak:
                problems.append(f"matmul {r}")
        for r in bw:
            if not _finite(r, "gb_per_s") or (
                    not r["note"] and float(r["gb_per_s"]) > 1.05 * 3350):
                problems.append(f"bandwidth {r}")

        base = root / "baseline"
        timed("baseline", lambda: baseline.main([
            "--batch-size", "32", "--dtype", "bfloat16", "--iters", "8",
            "--out", str(base)]))
        bl = _csv_dicts(base / "model_benchmarks.csv")
        rec["baseline"] = {r["model"]: {k: float(r[k]) for k in (
            "forward_ms", "backward_ms", "optimizer_ms", "total_ms",
            "samples_per_s", "peak_memory_mb")} for r in bl}
        if [r["model"] for r in bl] != list(baseline.MODEL_SPECS) or not all(
                _finite(r, "total_ms", "forward_ms") for r in bl):
            problems.append(f"baseline rows {bl}")

        att = root / "attention"
        rc = timed("attention_bench", lambda: attention_bench.main([
            "--seqs", "1024", "2048", "4096", "8192", "--out", str(att)]))
        ar = _csv_dicts(att / "attention_scaling.csv")
        rec["attention_ms"] = {
            f"{r['geometry']}_{r['mode']}_{r['impl']}_{r['seq']}":
            (float(r["per_iter_ms"]) if r["status"] == "ok" else r["status"])
            for r in ar}
        if rc != 0 or len(ar) != 32:
            problems.append(f"attention_bench rc {rc}, {len(ar)} rows")
        for r in ar:
            if r["status"] == "ok" and not (
                    _finite(r, "per_iter_ms", "achieved_tflops")
                    and float(r["achieved_tflops"]) <= 1.05 * 989.4):
                problems.append(f"attention {r}")
            elif r["status"] not in ("ok", "oom"):
                problems.append(f"attention {r}")

        comp = root / "compile"
        timed("compile_bench", lambda: compile_bench.main([
            "--repeat", "8", "--train-step", "--out", str(comp)]))
        cr = _csv_dicts(comp / "compilation_benchmark.csv")
        rec["compile_ms"] = {f"{r['model']}_{r['variant']}":
                             float(r["median_ms"]) for r in cr}
        if len(cr) != 11 or not all(_finite(r, "median_ms") for r in cr):
            problems.append(f"compile_bench rows {cr}")

        dec = root / "decode"
        timed("decode_bench", lambda: decode_bench.main([
            "--models", "tiny", "mid", "--out", str(dec)]))
        dr = _csv_dicts(dec / "decode_benchmarks.csv")
        rec["decode"] = {f"{r['model']}_{r['quant']}": {k: float(r[k]) for k in (
            "prefill_ms", "decode_ms_per_token", "decode_tokens_per_s",
            "lifetime_peak_mb")} for r in dr}
        if len(dr) != 4 or not all(_finite(r, "decode_ms_per_token",
                                           "prefill_ms") for r in dr):
            problems.append(f"decode_bench rows {dr}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(rec)
    if problems:
        raise AssertionError("phase1: " + "; ".join(map(str, problems)))
    return rec


def worker_main(argv: list[str]) -> int:
    """`chip_smoke.py --worker sharded OUT ARGS...`: the torchrun rank
    of the sharded phases; its readings go to OUT as JSON."""
    name, out, *args = argv
    if name != "sharded":
        raise ValueError(f"unknown worker {name!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = worker_sharded(out, *args)
    Path(out).write_text(json.dumps(rec))
    return 0


def kernels_line(serve_rec: dict, features_rec: dict, load_rec: dict,
                 train_rec: dict, long_rec: dict, llama_rec: dict,
                 resume_rec: dict, kernel_recs: dict,
                 flash_recs: dict, fsdp_rec: dict,
                 llama_fsdp_rec: dict, axes_recs: dict,
                 int8_kernel_recs: dict, int8_rec: dict,
                 d256_recs: dict, any_d_recs: dict,
                 head_dim_runs: dict) -> dict:
    """One record per kernel and run, at that run's shapes, with the
    kernel's launches on the run: the serve kernels at the decode tick
    (S=4 slots, one token, bf16, 7B widths); at serve_features, paged
    attention at the spec tick's verify window [4, 5] and a chunk
    segment [1, 256], RMSNorm at the verify window's [4, 5, 4096]; at
    load, the decode tick's records and paged attention at the window of
    a 456-token prompt whose 192-token prefix the radix holds; LayerNorm
    and the
    cross-entropy at the language_ddp train step (the train and
    train_resume runs, with leg A's launches for the latter) and at the
    train_long step; the flash kernels at the train_long step's layer (D 64) and
    at the Llama-2-7B LoRA train step (D 128), with the cross-entropy at
    that step's vocab and RMSNorm, forward and backward, at its
    [4096, 4096] rows; the same records at the sharded runs of the same
    shapes (train_fsdp: language_fsdp under FSDP2; llama_fsdp: the 7B
    full fine-tune, whose RMSNorm backward is the variant with dw), with
    those runs' launches; and the seq, pipe and expert runs' (train_moe
    and pipeline_lm at the train step's shapes, train_ulysses at
    train_long's with its flash kernels, train_ring and its xla
    baseline at train_long's in fp32); and the int8 run's (Llama-2-7B
    weight-only int8 at batch 4: the int8 product at each decode width
    and the 512-row prefill, the row quantizer at the decode and prefill
    activations and a weight, RMSNorm at the decode tick); and the D 256
    flash kernels (lm_d256: the bf16 kernels at the TransformerLM D 256
    step's layer, [2, 4096, 4, 256], with that step's launches;
    lm_d256_fp32: the fp32 kernels at the same layer, with the fp32
    step's launches; flash_d256_fp32: the fp32 kernels at [2, 1024, 8,
    256] causal, with the public entry's launches); and the head dims
    past the old instantiations (serve_odd_d and serve_wide_d: paged
    attention at their decode tick, [4, 1] fp32 at 32 heads of 72 over 8
    KV heads and 8 heads of 320 over 8, with each serve run's launches;
    lm_d512 and lm_d512_fp32: the wide flash kernels at the D 512 step's
    layer, [2, 4096, 2, 512], with that step's launches in each dtype).
    `run` names the run."""
    rng = np.random.default_rng(SEED + 4)
    bases = rng.integers(32, 532, 4)
    pa = check_paged("decode_tick_S4", paged_geometry(
        4, 1, 32, 32, torch.bfloat16, base=bases, seed=5),
        torch.bfloat16, timing=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(4, 1, 4096, generator=g, device="cuda").to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(4096, generator=g, device="cuda")
    rn = check_rms("decode_tick_S4", x, w, "block", timing=True)
    x = torch.randn(4, 5, 4096, generator=g, device="cuda").to(torch.bfloat16)
    rn_spec = check_rms("spec_tick_S4x5", x, w, "block", timing=True)
    pa_hit = check_paged("load_prefix_hit_1x264_base192", paged_geometry(
        1, 264, 32, 32, torch.bfloat16, base=[192], seed=9),
        torch.bfloat16, timing=True)
    csrc = "hyperion_tpu_torch/ops/csrc/"
    pallas = "hyperion_tpu/ops/pallas/"
    ring_recs = [("fused_layernorm",
                  kernel_recs["train_ring"]["fused_layernorm"]),
                 *[(k, v) for k, v in kernel_recs["train_long"].items()
                   if k.startswith("fused_softmax_xent")]]
    where = {"paged_attention": ("paged_attention.cu",
                                 "paged_attention.py:105"),
             "fused_rmsnorm": ("fused_norm.cu", "fused_norm.py:135"),
             "fused_rmsnorm_bwd": ("fused_norm.cu", "fused_norm.py:171"),
             "fused_layernorm": ("fused_norm.cu", "fused_norm.py:32"),
             "fused_softmax_xent_fwd": ("fused_ce.cu", "fused_ce.py:61"),
             "fused_softmax_xent_bwd": ("fused_ce.cu", "fused_ce.py:94"),
             "flash_attention_fwd": ("flash_attention.cu",
                                     "flash_attention.py:207"),
             "flash_attention_dq": ("flash_attention.cu",
                                    "flash_attention.py:351"),
             "flash_attention_dkv": ("flash_attention.cu",
                                     "flash_attention.py:405"),
             # no Pallas kernel: XLA's int8 dot_general with its fused
             # dequant epilogue, and its per-row quantize
             "int8_matmul": ("int8_matmul.cu",
                             "hyperion_tpu/precision/quant.py:69"),
             "quantize_rows": ("int8_matmul.cu",
                               "hyperion_tpu/precision/quant.py:47")}
    runs = (("serve", serve_rec, [("paged_attention", pa),
                                  ("fused_rmsnorm", rn)]),
            ("serve_features", features_rec,
             kernel_recs["serve_features"] + [("fused_rmsnorm", rn_spec)]),
            ("load", load_rec, [("paged_attention", pa),
                                ("paged_attention", pa_hit),
                                ("fused_rmsnorm", rn)]),
            ("train", train_rec, list(kernel_recs["train"].items())),
            ("train_resume", resume_rec, list(kernel_recs["train"].items())),
            ("train_long", long_rec, [*kernel_recs["train_long"].items(),
                                      *flash_recs["train_long"].items()]),
            ("llama_train", llama_rec, [*kernel_recs["llama_train"].items(),
                                        *flash_recs["llama_train"].items()]),
            ("train_fsdp", fsdp_rec, list(kernel_recs["train"].items())),
            ("llama_fsdp", llama_fsdp_rec,
             [*kernel_recs["llama_fsdp"].items(),
              *flash_recs["llama_train"].items()]),
            ("train_moe", axes_recs["train_moe"],
             list(kernel_recs["train"].items())),
            ("train_ulysses", axes_recs["train_ulysses"],
             [*kernel_recs["train_long"].items(),
              *flash_recs["train_long"].items()]),
            ("train_ring", axes_recs["train_ring"], ring_recs),
            ("train_ring_xla", {"launches": axes_recs["train_ring"][
                "xla_launches"]}, ring_recs),
            ("pipeline_lm", axes_recs["pipeline_lm"],
             list(kernel_recs["train"].items())),
            ("int8", int8_rec,
             [*(("int8_matmul", r) for r in int8_kernel_recs["int8_matmul"]),
              *(("quantize_rows", r)
                for r in int8_kernel_recs["quantize_rows"]),
              ("fused_rmsnorm", rn)]),
            *((run, d256_recs[run], list(flash_recs[run].items()))
              for run in ("lm_d256", "flash_d256_fp32")),
            # lm_d256's fp32 step on the kernels, at its layer's shape
            ("lm_d256_fp32", {"launches": d256_recs["lm_d256"][
                "launches_fp32_pallas"]},
             list(flash_recs["lm_d256_fp32"].items())),
            *((run, head_dim_runs[run], list(any_d_recs[run].items()))
              for run in ("serve_odd_d", "serve_wide_d", "lm_d512")),
            ("lm_d512_fp32", {"launches": head_dim_runs["lm_d512"][
                "launches_fp32_pallas"]},
             list(any_d_recs["lm_d512_fp32"].items())))
    out = []
    for run, run_rec, recs in runs:
        for name, rec in recs:
            src, rep = where[name]
            out.append({"name": name, "route": "cuda",
                        "source": csrc + rec.get("source", src),
                        "replaces": (rep if rep.startswith("hyperion_tpu/")
                                     else pallas + rep), "run": run,
                        "launches": run_rec["launches"][name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        "checked": rec["ok"], "case": rec["case"],
                        "shape": rec["shape"], "dtype": rec["dtype"],
                        **{key: rec[key] for key in
                           (*ATTR_KEYS, "function", "path", "grad_shape",
                            "bf16_linear_ms") if key in rec}})
    return {"kernels": out}


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the H100",
              file=sys.stderr)
        return 1
    import hyperion_tpu_torch  # noqa: F401 — fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    kernel_recs = phase_kernels()
    int8_kernel_recs = phase_int8_kernels()
    flash_recs = phase_flash()
    d256_recs = phase_lm_d256(dev["nvidia_smi"])
    any_d_recs = phase_any_head_dim()
    head_dim_runs = {"lm_d512": phase_lm_d512(dev["nvidia_smi"]),
                     **{run: phase_serve_head_dim(run, dev["nvidia_smi"])
                        for run in SERVE_HEAD_DIMS}}
    phase_train_model()
    train_rec = phase_train(dev["nvidia_smi"])
    long_rec = phase_train_long(dev["nvidia_smi"])
    resume_rec = phase_train_resume(dev["nvidia_smi"])
    phase_llama_train_model()
    llama_rec = phase_llama_train(dev["nvidia_smi"])
    runs = sharded_runs()
    phase_dist(dev["nvidia_smi"], runs)
    fsdp_rec = phase_train_fsdp(dev["nvidia_smi"], runs)
    llama_fsdp_rec = phase_llama_fsdp(dev["nvidia_smi"], runs)
    axes_recs = {
        "train_moe": phase_train_moe(dev["nvidia_smi"], runs),
        "train_ulysses": phase_train_ulysses(dev["nvidia_smi"], runs,
                                             long_rec),
        "train_ring": phase_train_ring(dev["nvidia_smi"], runs),
        "pipeline_lm": phase_pipeline_lm(dev["nvidia_smi"], runs)}
    phase_dry_init(dev["nvidia_smi"])
    phase_prepare(dev["nvidia_smi"])
    phase_cifar(dev["nvidia_smi"])
    phase_scaling(dev["nvidia_smi"])
    phase_model()
    phase_oracle()
    serve_rec, model, serve_reqs, serve_toks = phase_serve()
    gc.collect()  # the serve engine's pools go before the second engine's
    torch.cuda.empty_cache()
    features_rec = phase_serve_features(model, serve_reqs, serve_toks,
                                        dev["nvidia_smi"])
    gc.collect()  # the features engine's pools go before the load engine's
    torch.cuda.empty_cache()
    load_rec = phase_load(model, dev["nvidia_smi"])
    int8_rec = phase_int8(model, dev["nvidia_smi"])
    del model
    gc.collect()  # the 7B weights go before the crash phase's children
    torch.cuda.empty_cache()
    phase_phase1(dev["nvidia_smi"])
    # the crash phase's supervised server runs while the gather and route
    # phases do (their own processes and dirs; the export is written
    # before the server starts)
    crash = crash_start()
    phase_gather(crash["model"], dev["nvidia_smi"])
    phase_route(crash["model"], dev["nvidia_smi"])
    _, crash_model = crash_finish(crash)
    del crash
    phase_introspect(crash_model)
    del crash_model
    gc.collect()
    torch.cuda.empty_cache()
    phase_infer(dev["nvidia_smi"])
    emit(kernels_line(serve_rec, features_rec, load_rec, train_rec,
                      long_rec, llama_rec, resume_rec, kernel_recs,
                      flash_recs, fsdp_rec, llama_fsdp_rec, axes_recs,
                      int8_kernel_recs, int8_rec, d256_recs, any_d_recs,
                      head_dim_runs))
    emit({"phase": "total", "seconds": round(time.perf_counter() - t0, 3)})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
