"""The language-model trainer — `train_language_model` of
`hyperion_tpu/train/trainer.py:778-1033` on one card, with the lean
epoch loop of `:226-617`.

    train_language_model(cfg, job="language_ddp", device=None)

Data (`load_wikitext2`, one-device `ShardedBatches`) → the
SimpleTransformerLM at the configured precision and compile tier →
AdamW → epochs of train steps, each closed by a CSV row (the
`language_ddp` schema plus `val_loss`, `val_ppl`) → the final
`.npz` export. `_tier_impls` resolves the kernels exactly as the
reference does: tier "jit" runs plain PyTorch ops (no `torch.compile`,
no kernels); "jit+pallas" runs the fused LayerNorm and cross-entropy
kernels, and attention "auto", which is the plain einsum below 4096
tokens.

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
import math
import time
from typing import Callable

import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.checkpoint.io import export_gathered
from hyperion_tpu_torch.config import Config
from hyperion_tpu_torch.data.sharding import ShardedBatches
from hyperion_tpu_torch.data.text import load_wikitext2
from hyperion_tpu_torch.metrics.csv_logger import SCHEMAS, CsvLogger
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
from hyperion_tpu_torch.train.step import make_eval_step, make_train_step


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    loss: float
    duration_s: float
    extra: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainResult:
    """The reference's result less its checkpoint dir and preemption
    flag (neither exists in the port yet), plus per-step readings."""

    job: str
    run_id: str
    csv_path: str
    history: list[EpochRecord]
    # per train step, in order: the loss, and on a card the device time
    # between consecutive step ends (CUDA events)
    step_losses: list[float] = dataclasses.field(default_factory=list)
    step_ms: list[float] = dataclasses.field(default_factory=list)

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


def _lm_validation(cfg: Config, splits, device, loss_fn):
    """(eval_step, val_batches, eval_cols, extra_schema); all-None/()
    when validation is off or the split is absent."""
    if not (cfg.train.validate and "validation" in splits):
        return None, None, None, ()
    val_batches = ShardedBatches(
        splits["validation"].arrays(), cfg.train.batch_size, device,
        shuffle=False, seed=cfg.train.seed)
    eval_step = make_eval_step(
        lambda model, b: {"loss": loss_fn(model, b, None)[0]})
    return eval_step, val_batches, _lm_eval_cols, ("val_loss", "val_ppl")


def _check_supported(cfg: Config, job: str) -> None:
    t = cfg.train
    if job != "language_ddp":
        raise NotImplementedError(
            f"job {job!r}: the port trains language_ddp on one device; "
            "FSDP and meshes are ROADMAP A8")
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
                tracer: obs_trace.Tracer | None = None):
    """Returns (history, step_losses, step_ms)."""
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
                   gpus=n_devices, **extra)
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
    _check_supported(cfg, job)
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
                       step_losses=step_losses, step_ms=step_ms)
