"""The trainers — `train_language_model` (`:778-1033`) and `train_llama`
(`:1138-1400`) of `hyperion_tpu/train/trainer.py` on one card, with the
reference's epoch loop (`:167-775`).

    train_language_model(cfg, job="language_ddp", device=None)
    train_llama(cfg, job="llama", device=None)

Data (`load_wikitext2`, one-device `ShardedBatches`) → the
SimpleTransformerLM at the configured precision and compile tier →
AdamW → `_prepare_run` (CSV logger, tracer, chaos activation, then the
verified walk-back restore from `{base_dir}/checkpoints/{job}_1dev/`
and the resume epoch and step) → the epoch loop → the final `.npz`
export. `_tier_impls` resolves the kernels exactly as the reference
does: tier "jit" runs plain PyTorch ops (no `torch.compile`, no
kernels); "jit+pallas" runs the fused LayerNorm and cross-entropy
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

The epoch loop is the reference's: the batch prefetcher
(`prefetch_depth`; host rows on its thread, the copy to the card on
the loop's), chaos hooks before each step, the preemption guard's
stop-before-step check with a mid-epoch checkpoint, the health monitor
and its reactions (`health_policy`), `profile_dir`'s trace of the first
epoch run, the exposition socket, per-epoch gauges (memory,
throughput, input wait, MFU) and snapshot, the CSV row, validation and
the epoch-boundary checkpoint (async by default). Exits return
`preempted` as True (resumable; the CLI exits 75) or "health_abort"
(the CLI exits 4); every exit commits the in-flight save first.

Sync discipline: per step, a CUDA event marks each step's end on the
stream (no host sync), and the intervals between them are
`TrainResult.step_ms`; the epoch's duration is fenced by
`torch.cuda.synchronize`. On the card the health monitor judges the
epoch mean the CSV row already fetched; on the CPU, where each step
has run to its end anyway, it reads each step's loss and grad norm.

Not ported yet: FSDP, multi-device meshes, pipeline and MoE (A8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.checkpoint import io as ckpt
from hyperion_tpu_torch.checkpoint.io import export_gathered
from hyperion_tpu_torch.config import Config
from hyperion_tpu_torch.data.prefetch import Prefetcher
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
from hyperion_tpu_torch.obs.export import (
    DEFAULT_WINDOW_S,
    MetricsExporter,
    exposition_path,
)
from hyperion_tpu_torch.obs.health import HealthConfig, HealthMonitor
from hyperion_tpu_torch.obs.registry import (
    MetricsRegistry,
    compiled_flops,
    observe_device_memory,
    observe_input_wait,
    observe_mfu,
    observe_step,
    observe_throughput,
)
from hyperion_tpu_torch.precision.policy import get_policy
from hyperion_tpu_torch.testing import chaos as chaos_mod
from hyperion_tpu_torch.train.losses import next_token_loss
from hyperion_tpu_torch.train.state import TrainState, make_optimizer
from hyperion_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    seeded_generator,
)
from hyperion_tpu_torch.utils import profiling
from hyperion_tpu_torch.utils.preemption import PreemptionGuard


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    loss: float
    duration_s: float
    extra: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainResult:
    """The reference's result, plus per-step readings, the registry's
    last snapshot (the `mfu`, `input_wait_frac`, ... gauges) and the
    trained model (drop it to free its memory)."""

    job: str
    run_id: str
    csv_path: str
    checkpoint_dir: str | None
    history: list[EpochRecord]
    # False = ran to completion; True = preempted (resumable, CLI exit
    # 75); "health_abort" = the health policy stopped it (CLI exit 4)
    preempted: Any = False
    # per train step of this run, in order: the loss, and on a card the
    # device time between consecutive step ends (CUDA events)
    step_losses: list[float] = dataclasses.field(default_factory=list)
    step_ms: list[float] = dataclasses.field(default_factory=list)
    metrics: dict = dataclasses.field(default_factory=dict)
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
    if cfg.train.moe_experts > 0:
        raise NotImplementedError(
            "MoE (moe_experts) is not ported yet (ROADMAP A8)")


def _save_checkpoint(ckpt_dir: str, state: TrainState, tracer=None,
                     wait: bool = True) -> None:
    """Save + prune — the ONE implementation for the epoch-boundary,
    preemption and health paths. `wait=False` (the epoch boundary under
    `async_checkpoint`) returns once the host snapshot is queued: the
    write runs while the next epoch trains, and the previous save's
    commit (its manifest) lands inside this one's `save` first.
    Preemption and health saves wait: the process is about to exit, so
    the save must be durable before control returns."""
    ckpt.save(ckpt_dir, state, force=True, wait=wait, tracer=tracer)
    ckpt.prune(ckpt_dir, keep=2)  # the full state per epoch adds up


def _health_react(job: str, action: str, monitor: HealthMonitor,
                  state: TrainState, ckpt_dir, tracer) -> bool:
    """React to a HealthMonitor escalation; True means abort the run.
    `warn` prints (the event is already in the trace); `checkpoint`
    saves a step-tagged snapshot under the `health/` SUBDIR of the
    checkpoint dir — never in the root step namespace, where it would
    evict an epoch checkpoint from `prune(keep=2)` and could become the
    resume point. If ANY anomaly that fired is fatal, nothing saves:
    the optimizer already applied the non-finite update."""
    fired = monitor.last_escalated or monitor.anomalies[-1:]
    for anom in fired:
        print(f"[{job}] health[{action}]: {anom.kind} at step "
              f"{anom.step} (value {anom.value}"
              f"{', ' + str(anom.detail) if anom.detail else ''})")
    if action == "checkpoint" and ckpt_dir \
            and not any(a.fatal for a in fired):
        anom = fired[-1]
        with tracer.span("checkpoint", reason=f"health_{anom.kind}"):
            _save_checkpoint(f"{ckpt_dir}/health", state, tracer=tracer)
    return action == "abort"


@dataclasses.dataclass
class LoopResult:
    history: list[EpochRecord]
    # False = ran to completion; True = a preemption signal (resumable:
    # the CLI exits 75); "health_abort" = the health policy stopped a
    # diverged run (the CLI exits 4)
    preempted: Any
    step_losses: list[float]
    step_ms: list[float]
    metrics: dict


def _epoch_loop(*, job: str, cfg: Config, batches: ShardedBatches,
                state: TrainState, train_step, logger: CsvLogger,
                n_devices: int, device: torch.device,
                ckpt_dir: str | None = None, resume_epoch: int = 0,
                resume_step: int = 0, eval_step=None,
                eval_batches: ShardedBatches | None = None,
                eval_cols: Callable[[list], dict] | None = None,
                tracer: obs_trace.Tracer | None = None,
                extra_cols: dict | None = None,
                flops_fn: Callable[[dict], float | None]) -> LoopResult:
    """The reference's epoch loop on one device; the state trains in
    place. `preempted` set means the run stopped early — callers then
    skip the exports the reference skips. `extra_cols`: constant
    columns of every CSV row (the Llama trainer's `mode`); `flops_fn(
    batch)`: one step's FLOPs, for the MFU gauge."""
    history: list[EpochRecord] = []
    step_losses: list[float] = []
    step_ms: list[float] = []
    tracer = tracer or obs_trace.null_tracer()
    reg = MetricsRegistry()
    # restart lineage: the supervisor stamps HYPERION_ATTEMPT on each
    # child; every heartbeat carries it
    attempt = int(os.environ.get("HYPERION_ATTEMPT", "0") or 0)
    hb = obs_heartbeat.Heartbeat.for_tracer(
        tracer, every=cfg.train.heartbeat_every or 25,
        static={"attempt": attempt})
    # live exposition socket: obs.sock next to the heartbeat, answering
    # one registry snapshot per connection from host floats only
    exporter: Any = contextlib.nullcontext()
    if hb.enabled:
        def _live_payload() -> dict:
            return {"role": "trainer", "job": job, "run": tracer.run,
                    "phase": hb.last_phase, "step": hb.last_step,
                    "metrics": reg.snapshot(),
                    "windows": reg.windowed_snapshot(DEFAULT_WINDOW_S)}

        exporter = MetricsExporter(exposition_path(hb.path), _live_payload,
                                   label="train-obs")
    plan = chaos_mod.current()
    monitor = (HealthMonitor(HealthConfig(policy=cfg.train.health_policy),
                             tracer=tracer)
               if cfg.train.health_policy != "off" else None)
    hb.pulse(step=resume_step, phase="init", epoch=resume_epoch + 1)
    steps_per_epoch = _steps_per_epoch(cfg, batches)
    tokens_per_step = cfg.train.batch_size * cfg.train.seq_len
    flops_per_step: float | None = None
    flops_known = False
    dtype = str(state.model.cfg.compute_dtype).removeprefix("torch.")
    max_steps = cfg.train.steps_per_epoch or None
    on_card = device.type == "cuda"
    # the CPU runs each step to its end before the next; on the card
    # per-step scalars stay on the device until the epoch's end
    per_step_reads = not on_card
    guard = PreemptionGuard()
    # a latched signal hits the flight recorder the moment it lands
    guard.on_latch = lambda signum: (
        tracer.event("preempt_signal", signal=int(signum), attempt=attempt),
        hb.pulse(phase="preempt_latched"),
    )

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def done(preempted) -> LoopResult:
        return LoopResult(history, preempted, step_losses, step_ms,
                          reg.snapshot())

    def abort_exit(epoch: int, n_steps: int) -> LoopResult:
        tracer.event("health_abort", epoch=epoch, steps_done=n_steps,
                     **monitor.summary())
        hb.close(phase="aborted")
        print(f"[{job}] health policy ABORTED the run at global step "
              f"{state.step} (epoch {epoch}); exports skipped — the last "
              "epoch-boundary checkpoint is the last good state")
        return done("health_abort")

    with guard, exporter:
        for epoch in range(resume_epoch, cfg.train.epochs):
            # mid-epoch resume: only the interrupted epoch skips its
            # already-trained prefix
            start = resume_step if epoch == resume_epoch else 0
            prefix = state.epoch_losses if start else None
            state.epoch_losses = None
            stopping = aborting = False
            profile_this = cfg.train.profile_dir and epoch == resume_epoch
            # the prefetcher first in the `with`, so every exit drains
            # its worker before the save/export code below runs
            with Prefetcher(batches.host_epoch(epoch, start),
                            depth=cfg.train.prefetch_depth) as feed, \
                    profiling.capture(cfg.train.profile_dir
                                      if profile_this else None), \
                    tracer.span("epoch", step=epoch * steps_per_epoch
                                + start) as ep_span:
                t0 = time.perf_counter()
                device_metrics = []
                marks = [mark()] if on_card else []
                for i, host_batch in enumerate(feed, start):
                    if max_steps and i >= max_steps:
                        break
                    gstep = epoch * steps_per_epoch + i
                    if plan is not None:
                        # kill/sigterm/stall fire BEFORE the step trains:
                        # "kill@step=N" means steps 0..N-1 completed
                        plan.on_step(gstep)
                    # stop check BEFORE the step: a signal that lands
                    # during validation or checkpoint IO must not burn
                    # one more training step on the way out
                    if guard.triggered:
                        stopping = True
                        break
                    with tracer.span("train_step", step=gstep) as sp:
                        metrics = train_step(
                            state, batches.to_device(host_batch),
                            cfg.train.seed)
                    device_metrics.append(metrics)  # on device until the end
                    if on_card:
                        marks.append(mark())
                    observe_step(reg, sp.dur_s, tokens=tokens_per_step)
                    if cfg.train.heartbeat_every:
                        hb.beat(step=gstep, phase="train", epoch=epoch + 1)
                    if monitor is not None:
                        loss_val = (float(metrics["loss"])
                                    if per_step_reads else None)
                        if plan is not None and loss_val is not None:
                            loss_val = plan.poison_loss(gstep, loss_val)
                        action = monitor.observe_step(
                            gstep, loss=loss_val,
                            grad_norm=(float(metrics["grad_norm"])
                                       if per_step_reads else None),
                            step_time_s=sp.dur_s)
                        if action != "none" and _health_react(
                                job, action, monitor, state, ckpt_dir,
                                tracer):
                            aborting = True
                            break
                if on_card:
                    torch.cuda.synchronize(device)
                duration = time.perf_counter() - t0  # train-only
                ep_span.set(epoch=epoch + 1, steps=len(device_metrics))
            step_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            epoch_losses = (torch.stack([m["loss"] for m in device_metrics])
                            if device_metrics else None)
            if epoch_losses is not None:
                step_losses += epoch_losses.tolist()
                # the per-epoch gauges: memory, throughput and MFU from
                # the synchronized epoch duration, input wait, one
                # snapshot record; a step's FLOPs are counted once
                observe_device_memory(reg, device)
                observe_throughput(reg, duration, len(device_metrics),
                                   tokens=tokens_per_step
                                   * len(device_metrics))
                observe_input_wait(reg, feed.wait_s, duration)
                if not flops_known:
                    flops_per_step = flops_fn(host_batch)
                    flops_known = True
                observe_mfu(reg, flops_per_step,
                            duration / len(device_metrics), dtype=dtype,
                            n_devices=n_devices, device=device)
                tracer.snapshot(reg, step=epoch * steps_per_epoch + start
                                + len(device_metrics), epoch=epoch + 1)
            if prefix is not None:
                prefix = prefix.to(device)
                epoch_losses = (prefix if epoch_losses is None
                                else torch.cat([prefix, epoch_losses]))
            if aborting:
                return abort_exit(epoch + 1, len(device_metrics))
            planned = steps_per_epoch - start
            if stopping and len(device_metrics) < planned:
                # cut short mid-epoch: the state holds every COMPLETED
                # step; save and exit. The next run resumes this epoch
                # at its next batch and logs its row — over every step
                # of the epoch, from the losses the checkpoint carries
                tracer.event("preempted", epoch=epoch + 1, mid_epoch=True,
                             steps_done=len(device_metrics))
                hb.close(phase="preempted")
                if ckpt_dir:
                    state.epoch_losses = (None if epoch_losses is None
                                          else epoch_losses.cpu())
                    _save_checkpoint(ckpt_dir, state, tracer=tracer)
                    state.epoch_losses = None
                print(f"[{job}] preempted at global step {state.step} "
                      f"(epoch {epoch + 1}); "
                      + ("checkpoint saved — rerun to resume mid-epoch"
                         if ckpt_dir else "no checkpoint dir — state lost"))
                return done(True)
            loss = (float(epoch_losses.mean()) if epoch_losses is not None
                    else float("nan"))
            end_gstep = epoch * steps_per_epoch + start + len(device_metrics)
            if monitor is not None and not per_step_reads and device_metrics:
                # the card: judge the epoch mean, already fetched for the
                # CSV row — zero added reads; a NaN anywhere in the
                # epoch poisons the mean
                monitor_loss = loss
                if plan is not None:
                    monitor_loss = plan.poison_epoch(
                        epoch * steps_per_epoch + start, end_gstep, loss)
                action = monitor.observe_epoch(epoch + 1, end_gstep,
                                               monitor_loss)
                if action != "none" and _health_react(
                        job, action, monitor, state, ckpt_dir, tracer):
                    return abort_exit(epoch + 1, len(device_metrics))
            extra: dict = {}
            if eval_step is not None and eval_batches is not None:
                hb.pulse(step=end_gstep, phase="eval", epoch=epoch + 1)
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
            logger.log(epoch=row.epoch, loss=row.loss,
                       duration_s=row.duration_s, gpus=n_devices, **extra,
                       **(extra_cols or {}))
            extras = "".join(f" {k}={v:.4f}" for k, v in extra.items())
            print(f"[{job}] epoch {row.epoch}/{cfg.train.epochs} "
                  f"loss={loss:.4f}{extras} ({duration:.2f}s)")
            if ckpt_dir:
                hb.pulse(step=end_gstep, phase="checkpoint", epoch=epoch + 1)
                with tracer.span("checkpoint", epoch=epoch + 1):
                    _save_checkpoint(ckpt_dir, state, tracer=tracer,
                                     wait=not cfg.train.async_checkpoint)
            if stopping:
                # the signal came at the epoch's end: the epoch is
                # trained, logged and saved; resume starts the next one
                tracer.event("preempted", epoch=epoch + 1, mid_epoch=False)
                hb.close(phase="preempted")
                print(f"[{job}] preempted at epoch boundary "
                      f"{epoch + 1}/{cfg.train.epochs}; rerun to resume")
                return done(True)
    hb.close(phase="done")
    return done(False)


def _prepare_run(job: str, cfg: Config, state: TrainState, batches,
                 n_devices: int, device: torch.device, schema: tuple):
    """CSV logger + tracer + checkpoint restore and resume bookkeeping,
    shared by the trainers. Returns (logger, tracer, ckpt_dir,
    resume_epoch, resume_step); a restore fills `state` in place."""
    logger = CsvLogger(job, n_devices, cfg.train.base_dir, schema=schema)
    tracer = obs_trace.from_env(f"{cfg.train.base_dir}/telemetry.jsonl",
                                run=logger.run,
                                enabled_by_default=cfg.train.telemetry)
    t = cfg.train
    tracer.event("train_start", job=job, n_devices=n_devices,
                 batch_size=t.batch_size, seq_len=t.seq_len,
                 epochs=t.epochs, backend=device.type,
                 attempt=int(os.environ.get("HYPERION_ATTEMPT", "0") or 0))
    # activate the plan (or clear a previous run's) BEFORE restore:
    # corrupt_ckpt@latest corrupts at activation, and the walk-back
    # below must be what discovers it. The fire record persists under
    # base_dir so supervisor-restarted children never re-fire a fault.
    chaos_mod.activate(t.chaos, state_path=f"{t.base_dir}/chaos_state.json",
                       seed=t.seed,
                       checkpoint_root=f"{t.base_dir}/checkpoints")
    # per world size, as the reference names it (its param-tree tag is
    # empty without pipeline or MoE, which the port does not run yet)
    ckpt_dir = f"{t.base_dir}/checkpoints/{job}_{n_devices}dev"
    steps_per_epoch = _steps_per_epoch(cfg, batches)
    resume_epoch, resume_step = 0, 0
    if ckpt.restore(ckpt_dir, state, tracer=tracer) is not None:
        # step-level resume: the interrupted epoch continues from its
        # next untrained batch of the same seeded permutation
        resume_epoch = state.step // steps_per_epoch
        resume_step = state.step % steps_per_epoch
        at = f" step {resume_step}" if resume_step else ""
        print(f"[{job}] resumed from step {state.step} "
              f"(epoch {resume_epoch}{at})")
        tracer.event("resumed", step=state.step, epoch=resume_epoch)
    return logger, tracer, ckpt_dir, resume_epoch, resume_step


def _finish(tracer, loop: LoopResult) -> None:
    """Every exit: drain the in-flight async save before the exports
    (an uncommitted epoch-boundary save would otherwise be lost), then
    close the stream."""
    ckpt.wait_pending(tracer=tracer)
    ckpt.release_host_buffers()
    tracer.event("train_end", preempted=loop.preempted,
                 epochs_run=len(loop.history))
    tracer.close()


def _lm_flops(model: torch.nn.Module):
    """`flops_fn` for an LM: one step's products over a host batch,
    through the plain loss (the counter cannot see the kernels)."""
    def loss(m, b):
        logits = m(b["input_ids"], padding_mask=b["attention_mask"])
        return next_token_loss(logits, b["input_ids"], b["attention_mask"])

    return lambda batch: compiled_flops(model, loss, batch)


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

    logger, tracer, ckpt_dir, resume_epoch, resume_step = _prepare_run(
        job, cfg, state, batches, n_dev, dev,
        SCHEMAS[job] + tuple(extra_schema))
    loop = _epoch_loop(
        job=job, cfg=cfg, batches=batches, state=state,
        train_step=train_step, logger=logger, n_devices=n_dev, device=dev,
        ckpt_dir=ckpt_dir, resume_epoch=resume_epoch,
        resume_step=resume_step, eval_step=eval_step,
        eval_batches=val_batches, eval_cols=eval_cols, tracer=tracer,
        flops_fn=_lm_flops(model))
    _finish(tracer, loop)
    if not loop.preempted:
        # skipped on preemption and abort: a half-trained or diverged
        # tree must not overwrite a previous final export
        export_gathered(f"{t.base_dir}/checkpoints/{job}_final.npz",
                        params_to_jax(model))
    return TrainResult(job, logger.run, str(logger.path), ckpt_dir,
                       loop.history, loop.preempted,
                       step_losses=loop.step_losses, step_ms=loop.step_ms,
                       metrics=loop.metrics, model=model)


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

    logger, tracer, ckpt_dir, resume_epoch, resume_step = _prepare_run(
        job, cfg, state, batches, n_dev, dev,
        SCHEMAS["llama"] + tuple(extra_schema))
    loop = _epoch_loop(
        job=job, cfg=cfg, batches=batches, state=state,
        train_step=train_step, logger=logger, n_devices=n_dev, device=dev,
        ckpt_dir=ckpt_dir, resume_epoch=resume_epoch,
        resume_step=resume_step, eval_step=eval_step,
        eval_batches=val_batches, eval_cols=eval_cols, tracer=tracer,
        extra_cols={"mode": mode}, flops_fn=_lm_flops(model))
    _finish(tracer, loop)
    history = loop.history
    if history and not loop.preempted:
        _write_llama_summary(cfg, job, mode, logger.run, history, model,
                             base_count, splits[tsplit].source,
                             steps_per_epoch, dev)

    # the reference's rule: a preempted run still exports (the tree is
    # merely early-stopped); a health-aborted one must not (non-finite)
    ckpts = f"{t.base_dir}/checkpoints/{job}_{mode}"
    if loop.preempted == "health_abort":
        pass
    elif lora is not None:
        adapters = lora_mod.lora_params_to_jax(model.lora_params(), shapes,
                                               lora_cfg)
        export_gathered(f"{ckpts}_final.npz", adapters)
        if t.export_merged:
            merged = lora_mod.merge_lora(llama_mod.params_to_jax(model),
                                         adapters, lora_cfg)
            export_gathered(f"{ckpts}_merged.npz", merged)
    else:
        export_gathered(f"{ckpts}_final.npz", llama_mod.params_to_jax(model))
    return TrainResult(job, logger.run, str(logger.path), ckpt_dir, history,
                       loop.preempted, step_losses=loop.step_losses,
                       step_ms=loop.step_ms, metrics=loop.metrics,
                       model=model)


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
