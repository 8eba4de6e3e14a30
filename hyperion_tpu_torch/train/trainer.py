"""The trainers — `train_language_model` (`:778-1033`) and `train_llama`
(`:1138-1400`) of `hyperion_tpu/train/trainer.py` on one card, with the
lean epoch loop of `:226-617`.

    train_language_model(cfg, job="language_ddp", device=None)
    train_llama(cfg, job="llama", device=None)

Data (`load_wikitext2`, one-device `ShardedBatches`) → the
SimpleTransformerLM at the configured precision and compile tier →
AdamW → epochs of train steps, each closed by a CSV row (the
`language_ddp` schema plus `val_loss`, `val_ppl`) → the final
`.npz` export. `_tier_impls` resolves the kernels exactly as the
reference does: tier "jit" runs plain PyTorch ops (no `torch.compile`,
no kernels); "jit+pallas" runs the fused LayerNorm and cross-entropy
kernels, and attention "auto", which is the plain einsum below 4096
tokens.

`train_llama` fine-tunes Llama (`cfg.train.model`: llama_tiny, llama_7b
or llama_70b) in the reference's two modes: `cfg.train.lora` trains
adapters on a frozen base ("lora_bf16": AdamW, clipping and decay over
the adapters only — the reference's `optax.multi_transform` freeze, so
the base has no gradient and no optimizer state), else every parameter
("fsdp_bf16", on one device). Ids are clamped into the Llama vocab;
weights are seeded random, or HF weights from
`{data_dir or base_dir}/llama2_hf` when that holds any. Each run writes
the CSV (schema "llama" + `mode`), a summary JSON with step time,
tokens/s and the allocator's peak memory, and the exports: the adapters
in the JAX adapter layout (or every parameter), and with
`export_merged` the merged base.

The loop keeps the reference's telemetry vocabulary: `train_start` /
`train_end` events, `epoch`, `train_step` and `eval` spans, heartbeat
pulses (init / train / eval / done), `steps_per_epoch` capping both
loops. The epoch's duration is fenced by `torch.cuda.synchronize`; per
step, a CUDA event marks each step's end on the stream (no host sync),
and the intervals between them are `TrainResult.step_ms`.

Not ported yet, and raising where a config asks for them: the health
monitor (`health_policy` other than "off"), chaos plans, the batch
prefetcher, profiling (ROADMAP A7), FSDP, multi-device meshes, pipeline
and MoE (A8). Absent without a switch, as the reference has none:
train-state checkpoints with restore and resume, the exposition socket,
the MFU and throughput gauges and the supervisor (A7).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.checkpoint.io import export_gathered
from hyperion_tpu_torch.config import Config
from hyperion_tpu_torch.data.sharding import ShardedBatches
from hyperion_tpu_torch.data.text import load_wikitext2
from hyperion_tpu_torch.metrics.csv_logger import SCHEMAS, CsvLogger
from hyperion_tpu_torch.models import llama as llama_mod
from hyperion_tpu_torch.models import lora as lora_mod
from hyperion_tpu_torch.models.transformer_lm import (
    TransformerLM,
    params_to_jax,
    simple_lm_config,
)
from hyperion_tpu_torch.obs import heartbeat as obs_heartbeat
from hyperion_tpu_torch.obs import trace as obs_trace
from hyperion_tpu_torch.precision.policy import get_policy
from hyperion_tpu_torch.train.losses import next_token_loss
from hyperion_tpu_torch.train.state import TrainState, make_optimizer
from hyperion_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    seeded_generator,
)


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    loss: float
    duration_s: float
    extra: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainResult:
    """The reference's result less its checkpoint dir and preemption
    flag (neither exists in the port yet), plus per-step readings and
    the trained model (drop it to free its memory)."""

    job: str
    run_id: str
    csv_path: str
    history: list[EpochRecord]
    # per train step, in order: the loss, and on a card the device time
    # between consecutive step ends (CUDA events)
    step_losses: list[float] = dataclasses.field(default_factory=list)
    step_ms: list[float] = dataclasses.field(default_factory=list)
    model: torch.nn.Module | None = None

    @property
    def final_loss(self) -> float:
        return self.history[-1].loss if self.history else float("nan")


def _steps_per_epoch(cfg: Config, batches) -> int:
    """Optimizer steps one epoch runs: the dataset's batch count, capped
    by cfg.train.steps_per_epoch (0 = full pass)."""
    return min(len(batches), cfg.train.steps_per_epoch or len(batches))


def _mean_of(metric_stack: list[dict], key: str) -> float:
    """Epoch-end mean of a per-step metric: one stacked reduce, one
    read back."""
    if not metric_stack:
        return float("nan")
    return float(torch.stack([m[key] for m in metric_stack]).mean())


def _tier_impls(cfg: Config) -> dict[str, str]:
    """`optimization.compile_tier` → per-op impl selections. The
    "jit+pallas" tier swaps in the kernels; attention left unset
    resolves per geometry ("auto")."""
    pallas = cfg.optimization.compile_tier in ("jit+pallas", "pallas")
    impl = "pallas" if pallas else "xla"
    attn = cfg.optimization.attention_impl or ("auto" if pallas else impl)
    if attn == "ulysses" and pallas:
        attn = "ulysses:pallas"
    return {"attention_impl": attn, "norm_impl": impl, "loss_impl": impl}


def _model_impls(tier_impl: dict) -> dict:
    """The subset of `_tier_impls` that model configs accept."""
    return {k: tier_impl[k] for k in ("attention_impl", "norm_impl")}


def _lm_eval_cols(vm: list) -> dict:
    """val_loss + perplexity; NaN when the val split gave no batch."""
    if not vm:
        return {"val_loss": float("nan"), "val_ppl": float("nan")}
    vl = _mean_of(vm, "loss")
    return {"val_loss": vl, "val_ppl": math.exp(min(vl, 20.0))}


def _lm_validation(cfg: Config, splits, device, loss_fn, transform=None):
    """(eval_step, val_batches, eval_cols, extra_schema); all-None/()
    when validation is off or the split is absent. `transform` maps the
    split to arrays (the Llama trainer's id clamping)."""
    if not (cfg.train.validate and "validation" in splits):
        return None, None, None, ()
    split = splits["validation"]
    val_batches = ShardedBatches(
        transform(split) if transform else split.arrays(),
        cfg.train.batch_size, device, shuffle=False, seed=cfg.train.seed)
    eval_step = make_eval_step(
        lambda model, b: {"loss": loss_fn(model, b, None)[0]})
    return eval_step, val_batches, _lm_eval_cols, ("val_loss", "val_ppl")


def _check_supported(cfg: Config) -> None:
    t = cfg.train
    for asked, what, item in (
            (t.health_policy != "off", f"health_policy={t.health_policy!r}",
             "A7"),
            (bool(t.chaos), "chaos plans", "A7"),
            (t.prefetch_depth > 0, "the batch prefetcher (prefetch_depth)",
             "A7"),
            (bool(t.profile_dir), "profiling (profile_dir)", "A7"),
            (t.moe_experts > 0, "MoE (moe_experts)", "A8")):
        if asked:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})")


def _epoch_loop(*, job: str, cfg: Config, batches: ShardedBatches,
                state: TrainState, train_step, logger: CsvLogger,
                n_devices: int, device: torch.device, eval_step=None,
                eval_batches: ShardedBatches | None = None,
                eval_cols: Callable[[list], dict] | None = None,
                tracer: obs_trace.Tracer | None = None,
                extra_cols: dict | None = None):
    """Returns (history, step_losses, step_ms). `extra_cols`: constant
    columns of every CSV row (the Llama trainer's `mode`)."""
    history: list[EpochRecord] = []
    step_losses: list[float] = []
    step_ms: list[float] = []
    tracer = tracer or obs_trace.null_tracer()
    hb = obs_heartbeat.Heartbeat.for_tracer(
        tracer, every=cfg.train.heartbeat_every or 25)
    hb.pulse(step=0, phase="init", epoch=1)
    steps_per_epoch = _steps_per_epoch(cfg, batches)
    max_steps = cfg.train.steps_per_epoch or None
    on_card = device.type == "cuda"

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    for epoch in range(cfg.train.epochs):
        with tracer.span("epoch", step=epoch * steps_per_epoch) as ep_span:
            t0 = time.perf_counter()
            device_metrics = []
            marks = [mark()] if on_card else []
            for i, batch in enumerate(batches.epoch(epoch)):
                if max_steps and i >= max_steps:
                    break
                gstep = epoch * steps_per_epoch + i
                with tracer.span("train_step", step=gstep):
                    metrics = train_step(state, batch, cfg.train.seed)
                device_metrics.append(metrics)  # on device until epoch end
                if on_card:
                    marks.append(mark())
                if cfg.train.heartbeat_every:
                    hb.beat(step=gstep, phase="train", epoch=epoch + 1)
            if on_card:
                torch.cuda.synchronize(device)
            duration = time.perf_counter() - t0  # train-only
            ep_span.set(epoch=epoch + 1, steps=len(device_metrics))
        step_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        if device_metrics:
            step_losses += torch.stack(
                [m["loss"] for m in device_metrics]).tolist()
        loss = _mean_of(device_metrics, "loss")
        extra: dict = {}
        if eval_step is not None and eval_batches is not None:
            hb.pulse(step=epoch * steps_per_epoch + len(device_metrics),
                     phase="eval", epoch=epoch + 1)
            with tracer.span("eval") as ev_span:
                val_metrics = []
                for i, vbatch in enumerate(eval_batches.epoch(0)):
                    if max_steps and i >= max_steps:
                        break
                    val_metrics.append(eval_step(state, vbatch))
                if on_card:
                    torch.cuda.synchronize(device)
                ev_span.set(epoch=epoch + 1, batches=len(val_metrics))
            extra.update(eval_cols(val_metrics))
        row = EpochRecord(epoch + 1, loss, duration, extra)
        history.append(row)
        logger.log(epoch=row.epoch, loss=row.loss, duration_s=row.duration_s,
                   gpus=n_devices, **extra, **(extra_cols or {}))
        extras = "".join(f" {k}={v:.4f}" for k, v in extra.items())
        print(f"[{job}] epoch {row.epoch}/{cfg.train.epochs} "
              f"loss={loss:.4f}{extras} ({duration:.2f}s)")
    hb.close(phase="done")
    return history, step_losses, step_ms


def train_language_model(cfg: Config, job: str = "language_ddp",
                         device=None) -> TrainResult:
    """Train the SimpleTransformerLM on WikiText-2 (its arrow, npz or
    synthetic split under `data_dir or base_dir`) on one device (None =
    cuda:0). Writes `{base_dir}/distributed/<run>_metrics.csv`,
    `{base_dir}/telemetry.jsonl` (+ `heartbeat.json`) and
    `{base_dir}/checkpoints/{job}_final.npz`."""
    dev = resolve_device(device)
    if job != "language_ddp":
        raise NotImplementedError(
            f"job {job!r}: the port trains language_ddp here and Llama in "
            "train_llama, on one device; FSDP and meshes are ROADMAP A8")
    _check_supported(cfg)
    n_dev = 1
    t = cfg.train

    tsplit = t.train_split
    want = (tsplit, "validation") if t.validate else (tsplit,)
    splits = load_wikitext2(t.data_dir or t.base_dir, splits=want,
                            seq_len=t.seq_len, seed=t.seed)
    print(f"[{job}] train split {tsplit!r}: {len(splits[tsplit])} rows, "
          f"source={splits[tsplit].source}")
    batches = ShardedBatches(splits[tsplit].arrays(), t.batch_size, dev,
                             shuffle=True, seed=t.seed)
    steps_per_epoch = _steps_per_epoch(cfg, batches)
    if steps_per_epoch <= 0:
        raise ValueError(
            f"zero steps per epoch: batch_size {t.batch_size} vs dataset "
            f"of {batches.n} examples (drop_last semantics)")

    policy = get_policy(cfg.optimization.precision)
    tier_impl = _tier_impls(cfg)
    model = TransformerLM(simple_lm_config(
        max_len=t.seq_len, dropout=0.1, remat=cfg.optimization.remat,
        dtype=str(policy.compute_dtype).removeprefix("torch."),
        **_model_impls(tier_impl)), device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(t.seed))
    model.to(policy.param_dtype)
    optimizer = make_optimizer(
        model.parameters(), t.learning_rate, t.weight_decay,
        cfg.optimization.grad_clip_norm, schedule=t.lr_schedule,
        warmup_steps=t.warmup_steps,
        total_steps=steps_per_epoch * t.epochs)
    state = TrainState(step=0, model=model, optimizer=optimizer)

    def loss_fn(model, batch, generator):
        logits = model(batch["input_ids"],
                       padding_mask=batch["attention_mask"],
                       deterministic=generator is None, generator=generator)
        loss = next_token_loss(logits, batch["input_ids"],
                               batch["attention_mask"],
                               impl=tier_impl["loss_impl"])
        return loss, {"loss": loss}

    train_step = make_train_step(
        loss_fn, grad_accum=cfg.optimization.grad_accum_steps, dropout=True)
    eval_step, val_batches, eval_cols, extra_schema = _lm_validation(
        cfg, splits, dev, loss_fn)

    logger = CsvLogger(job, n_dev, t.base_dir,
                       schema=SCHEMAS[job] + tuple(extra_schema))
    tracer = obs_trace.from_env(f"{t.base_dir}/telemetry.jsonl",
                                run=logger.run,
                                enabled_by_default=t.telemetry)
    tracer.event("train_start", job=job, n_devices=n_dev,
                 batch_size=t.batch_size, seq_len=t.seq_len,
                 epochs=t.epochs, backend=dev.type)
    history, step_losses, step_ms = _epoch_loop(
        job=job, cfg=cfg, batches=batches, state=state,
        train_step=train_step, logger=logger, n_devices=n_dev, device=dev,
        eval_step=eval_step, eval_batches=val_batches, eval_cols=eval_cols,
        tracer=tracer)
    tracer.event("train_end", preempted=False, epochs_run=len(history))
    tracer.close()
    export_gathered(f"{t.base_dir}/checkpoints/{job}_final.npz",
                    params_to_jax(model))
    return TrainResult(job, logger.run, str(logger.path), history,
                       step_losses=step_losses, step_ms=step_ms, model=model)


_LLAMA_SIZES = {
    "llama_tiny": llama_mod.llama_tiny_config,
    "llama_7b": llama_mod.llama2_7b_config,
    "llama_70b": llama_mod.llama2_70b_config,
}


def train_llama(cfg: Config, job: str = "llama", device=None) -> TrainResult:
    """Fine-tune Llama on one device (None = cuda:0), LoRA or full (see
    the module docstring). Writes `{base_dir}/distributed/<run>_metrics.csv`
    and `<run>_summary.json`, `{base_dir}/telemetry.jsonl` (+
    `heartbeat.json`) and `{base_dir}/checkpoints/{job}_{mode}_final.npz`
    (+ `_merged.npz` with `export_merged`)."""
    dev = resolve_device(device)
    _check_supported(cfg)
    if cfg.train.model not in _LLAMA_SIZES:
        raise ValueError(f"unknown Llama size {cfg.train.model!r}; have "
                         f"{sorted(_LLAMA_SIZES)}")
    n_dev = 1
    t = cfg.train
    tier_impl = _tier_impls(cfg)
    llcfg = _LLAMA_SIZES[t.model](
        # the tiny config's 64-token context stretches to the data's
        # window, or RoPE runs out of table rows
        max_len=max(t.seq_len, 128 if t.model != "llama_tiny" else 64),
        remat=cfg.optimization.remat, **_model_impls(tier_impl))
    mode = "lora_bf16" if t.lora else "fsdp_bf16"
    lora_cfg = lora_mod.LoraConfig(rank=t.lora_rank, alpha=t.lora_alpha)

    tsplit = t.train_split
    want = (tsplit, "validation") if t.validate else (tsplit,)
    splits = load_wikitext2(t.data_dir or t.base_dir, splits=want,
                            seq_len=t.seq_len, seed=t.seed)
    print(f"[{job}] train split {tsplit!r}: {len(splits[tsplit])} rows, "
          f"source={splits[tsplit].source}")

    def clamped(split):  # GPT-2-vocab ids clamped into the Llama vocab
        return {"input_ids": np.minimum(split.input_ids,
                                        llcfg.vocab_size - 1),
                "attention_mask": split.attention_mask}

    batches = ShardedBatches(clamped(splits[tsplit]), t.batch_size, dev,
                             shuffle=True, seed=t.seed)
    steps_per_epoch = _steps_per_epoch(cfg, batches)
    if steps_per_epoch <= 0:
        raise ValueError(
            f"zero steps per epoch: batch_size {t.batch_size} vs dataset "
            f"of {batches.n} examples (drop_last semantics)")

    # the adapters' module targets come from the adapter dict itself, so
    # the two lists cannot diverge (`target_module_names`)
    shapes = llama_mod.jax_kernel_shapes(llcfg)
    lora = (lora_mod.init_lora_params(seeded_generator(dev, t.seed, 1),
                                      shapes, lora_cfg) if t.lora else None)
    if lora is not None:
        llcfg = dataclasses.replace(
            llcfg, lora_rank=lora_cfg.rank, lora_scale=lora_cfg.scale,
            lora_targets=lora_mod.target_module_names(lora))
    model = llama_mod.Llama(llcfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(t.seed))
    if lora is not None:
        model.load_lora(lora)
    hf_dir = f"{t.data_dir or t.base_dir}/llama2_hf"
    hf = llama_mod.load_hf_checkpoint(hf_dir, llcfg)
    if hf is not None:
        res = model.load_state_dict(llama_mod.params_from_jax(hf, llcfg),
                                    strict=False)  # the adapters stay
        if res.unexpected_keys or any(
                not k.endswith(("lora_a", "lora_b")) for k in res.missing_keys):
            raise ValueError(f"HF weights in {hf_dir} do not fit the model: "
                             f"{res}")
        print(f"[{job}] loaded HF weights from {hf_dir}")
    # the reference's policy: bf16 params throughout ("bf16_full") at a
    # bf16 compute dtype, else fp32; the rope table stays fp32
    policy = get_policy("bf16_full" if llcfg.compute_dtype == torch.bfloat16
                        else "fp32")
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(policy.param_dtype)
    if lora is None:
        for p in model.parameters():
            p.requires_grad_(True)
    base_count = sum(p.numel() for n, p in model.named_parameters()
                     if not n.endswith(("lora_a", "lora_b")))
    if lora is not None:
        frac = lora_mod.count_params(model.lora_params()) / base_count
        print(f"[{job}] mode={mode} trainable params: {100 * frac:.3f}% "
              "of base")
    optimizer = make_optimizer(
        model.parameters(), t.learning_rate, t.weight_decay,
        cfg.optimization.grad_clip_norm, schedule=t.lr_schedule,
        warmup_steps=t.warmup_steps, total_steps=steps_per_epoch * t.epochs)
    state = TrainState(step=0, model=model, optimizer=optimizer)

    def loss_fn(model, batch, generator):
        logits = model(batch["input_ids"],
                       padding_mask=batch["attention_mask"])
        loss = next_token_loss(logits, batch["input_ids"],
                               batch["attention_mask"],
                               impl=tier_impl["loss_impl"])
        return loss, {"loss": loss}

    train_step = make_train_step(
        loss_fn, grad_accum=cfg.optimization.grad_accum_steps)
    eval_step, val_batches, eval_cols, extra_schema = _lm_validation(
        cfg, splits, dev, loss_fn, transform=clamped)

    logger = CsvLogger(job, n_dev, t.base_dir,
                       schema=SCHEMAS["llama"] + tuple(extra_schema))
    tracer = obs_trace.from_env(f"{t.base_dir}/telemetry.jsonl",
                                run=logger.run,
                                enabled_by_default=t.telemetry)
    tracer.event("train_start", job=job, n_devices=n_dev,
                 batch_size=t.batch_size, seq_len=t.seq_len,
                 epochs=t.epochs, backend=dev.type)
    history, step_losses, step_ms = _epoch_loop(
        job=job, cfg=cfg, batches=batches, state=state,
        train_step=train_step, logger=logger, n_devices=n_dev, device=dev,
        eval_step=eval_step, eval_batches=val_batches, eval_cols=eval_cols,
        tracer=tracer, extra_cols={"mode": mode})
    tracer.event("train_end", preempted=False, epochs_run=len(history))
    tracer.close()
    if history:
        _write_llama_summary(cfg, job, mode, logger.run, history, model,
                             base_count, splits[tsplit].source,
                             steps_per_epoch, dev)

    ckpts = f"{t.base_dir}/checkpoints/{job}_{mode}"
    if lora is not None:
        adapters = lora_mod.lora_params_to_jax(model.lora_params(), shapes,
                                               lora_cfg)
        export_gathered(f"{ckpts}_final.npz", adapters)
        if t.export_merged:
            merged = lora_mod.merge_lora(llama_mod.params_to_jax(model),
                                         adapters, lora_cfg)
            export_gathered(f"{ckpts}_merged.npz", merged)
    else:
        export_gathered(f"{ckpts}_final.npz", llama_mod.params_to_jax(model))
    return TrainResult(job, logger.run, str(logger.path), history,
                       step_losses=step_losses, step_ms=step_ms, model=model)


def _write_llama_summary(cfg: Config, job: str, mode: str, run: str,
                         history: list[EpochRecord], model, base_count: int,
                         data_source: str, steps: int,
                         device: torch.device) -> dict:
    """The reference's evidence row for the Llama path (`:1308-1380`):
    step time and tokens/s from the best epoch, the peak device memory
    from the allocator (None on the CPU, which has none)."""
    t = cfg.train
    if device.type == "cuda":
        peak_mb = round(torch.cuda.max_memory_allocated(device) / 1e6, 1)
        peak_source = "allocator"
    else:
        peak_mb, peak_source = None, "none — the CPU has no device allocator"
    best_s = min(h.duration_s for h in history)
    summary = {
        "job": job, "mode": mode, "model": t.model,
        "batch_size": t.batch_size, "seq_len": t.seq_len,
        "steps_per_epoch": steps, "epochs_run": len(history),
        "best_epoch_s": round(best_s, 2),
        "step_ms": round(best_s / steps * 1e3, 1),
        "tokens_per_s": round(t.batch_size * t.seq_len * steps / best_s, 1),
        "final_loss": round(history[-1].loss, 4),
        "params_m": round(sum(p.numel() for p in model.parameters()) / 1e6,
                          1),
        "peak_hbm_mb": peak_mb, "peak_hbm_source": peak_source,
        "data_source": data_source, "train_split": t.train_split,
        "remat": cfg.optimization.remat,
        "grad_accum": cfg.optimization.grad_accum_steps,
        "devices": 1, "backend": device.type,
    }
    if t.lora:
        summary["lora_rank"] = t.lora_rank
    path = Path(f"{t.base_dir}/distributed/{run}_summary.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(summary, indent=2))
    print(f"[{job}] summary: {json.dumps(summary)}")
    return summary
