"""The train step — `hyperion_tpu/train/step.py:42-140`, eager.

One step: forward and backward (over `grad_accum` microbatches, the
gradients averaged and the declared count metrics summed), the global
gradient norm recorded before clipping (`:121` there), then one
optimizer update (clip by that same norm, schedule, AdamW). Metrics
stay on the device. The step itself reads nothing back to the host,
but the kernel loss (`ops/fused_ce.py`) reads the targets' range once
a call to check it, and that read waits for the forward so far.

Dropout, when on, draws from a generator seeded from (seed, step) —
and the microbatch index under accumulation — so a step's masks do not
depend on what ran before it. They cannot equal JAX's dropout bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from hyperion_tpu_torch.train.state import TrainState, global_norm

# loss_fn(model, batch, generator or None) -> (loss, metrics dict)
LossFn = Callable[[torch.nn.Module, dict, torch.Generator | None],
                  tuple[torch.Tensor, dict]]


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A generator on `device` seeded from `keys` (seed, step, ...)
    through numpy's SeedSequence, so nearby keys give unrelated
    streams: dropout's, and the LoRA adapters' init (seed, 1) — the
    reference's `fold_in`."""
    seed = int(np.random.SeedSequence(list(keys)).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by grad_accum {n}")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(loss_fn: LossFn, grad_accum: int = 1,
                    dropout: bool = False,
                    sum_metrics: tuple[str, ...] = ("correct", "total")):
    """`(state, batch, seed) -> metrics`: one optimizer update of
    `state` in place; `state.step` advances by one. `sum_metrics` names
    the count metrics summed over microbatches; the rest are
    averaged."""

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        opt.zero_grad()
        if grad_accum == 1:
            gen = seeded_generator(dev, seed, state.step) if dropout else None
            loss, metrics = loss_fn(model, batch, gen)
            loss.backward()
        else:
            parts = []
            for i, mb in enumerate(_split_microbatches(batch, grad_accum)):
                # an independent mask per microbatch, as the reference
                # folds the microbatch index into its key
                gen = (seeded_generator(dev, seed, state.step, i)
                       if dropout else None)
                loss, m = loss_fn(model, mb, gen)
                loss.backward()  # .grad sums over the microbatches
                parts.append(m)
            for p in opt.params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
            metrics = {k: torch.stack([m[k] for m in parts]).sum(0)
                       if k in sum_metrics
                       else torch.stack([m[k] for m in parts]).mean(0)
                       for k in parts[0]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(
            [p.grad for p in opt.params if p.grad is not None])
        opt.step(metrics["grad_norm"])
        state.step += 1
        return metrics

    return train_step


def make_eval_step(eval_fn: Callable[[torch.nn.Module, dict], dict]):
    """`(state, batch) -> metrics` without gradients."""

    def step(state: TrainState, batch: dict) -> dict:
        with torch.no_grad():
            return eval_fn(state.model, batch)

    return step
