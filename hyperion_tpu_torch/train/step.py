"""The train step — `hyperion_tpu/train/step.py:42-140`, eager.

One step: forward and backward (over `grad_accum` microbatches, the
gradients averaged and the declared count metrics summed), the global
gradient norm recorded before clipping (`:121` there), then one
optimizer update (clip by that same norm, schedule, AdamW). Metrics
stay on the device. The step itself reads nothing back to the host,
but the kernel loss (`ops/fused_ce.py`) reads the targets' range once
a call to check it, and that read waits for the forward so far.

Dropout, when on, draws from a generator seeded from (seed, step) —
and the microbatch index under accumulation, and the rank's batch shard
when there is more than one — so a step's masks do not depend on what
ran before it. They cannot equal JAX's dropout bits.

Under data parallelism a `BatchSync` over the batch axes' groups makes
the step's numbers global, as the JAX step's are over a sharded batch:
the loss is this rank's share of the global mean (`global_mean`: its
sum over the count of real tokens on every rank, times the number of
batch shards, so that the gradient average DDP and FSDP take is the
gradient of the global mean), the metrics are averaged over the ranks,
and `grad_sync` (the DDP all-reduce, `parallel/partition.py` `GradSync`)
runs after the backward. Under grad accumulation each rank splits its
own rows into microbatches, and each microbatch's loss is its global
mean: the JAX step splits the global batch instead, so with ragged
padding the two weigh microbatches differently (ROADMAP C).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from hyperion_tpu_torch.train.state import TrainState, global_norm


class BatchSync:
    """The data-parallel reductions over `groups` (the batch axes' groups
    larger than one, `runtime/mesh.py` `batch_groups`), `world` ranks
    in all; `index` is this rank's batch shard. Inactive (every method
    the identity) when `groups` is empty, so a world-1 run computes
    exactly what a single process does."""

    def __init__(self, groups: list | None = None, world: int = 1,
                 index: int = 0):
        self.groups = list(groups or [])
        self.world = world
        self.index = index

    @property
    def active(self) -> bool:
        return bool(self.groups)

    @property
    def fold(self) -> tuple:
        """Key for this rank's dropout stream (none on one shard)."""
        return (self.index,) if self.active else ()

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as tdist

        for group in self.groups:
            tdist.all_reduce(t, group=group)
        return t

    def global_mean(self, num: torch.Tensor, count: torch.Tensor
                    ) -> torch.Tensor:
        """This rank's share of sum(num) / sum(count) over the ranks:
        `num * world / sum(count)`; averaged over the ranks (as DDP and
        FSDP average gradients) it is the global mean."""
        if not self.active:
            return num / count.clamp_min(1.0)
        total = self._sum(count.detach().float().clone())
        return num * self.world / total.clamp_min(1.0)

    def mean(self, metrics: dict) -> dict:
        """Metrics averaged over the ranks, in one all-reduce."""
        if not self.active or not metrics:
            return metrics
        keys = sorted(metrics)
        v = self._sum(torch.stack([metrics[k].float() for k in keys]))
        return dict(zip(keys, (v / self.world).unbind()))

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
                    sum_metrics: tuple[str, ...] = ("correct", "total"),
                    sync: BatchSync | None = None,
                    grad_sync: Callable[[], None] | None = None):
    """`(state, batch, seed) -> metrics`: one optimizer update of
    `state` in place; `state.step` advances by one. `sum_metrics` names
    the count metrics summed over microbatches; the rest are
    averaged. `sync` makes the metrics global (the loss_fn makes the
    loss so); `grad_sync` runs after the last backward."""
    sync = sync or BatchSync()

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        opt.zero_grad()
        if grad_accum == 1:
            gen = (seeded_generator(dev, seed, state.step, *sync.fold)
                   if dropout else None)
            loss, metrics = loss_fn(model, batch, gen)
            loss.backward()
        else:
            parts = []
            for i, mb in enumerate(_split_microbatches(batch, grad_accum)):
                # an independent mask per microbatch, as the reference
                # folds the microbatch index into its key
                gen = (seeded_generator(dev, seed, state.step, i,
                                        *sync.fold)
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
        if grad_sync is not None:
            grad_sync()
        metrics = sync.mean({k: v.detach() for k, v in metrics.items()})
        metrics["grad_norm"] = global_norm(
            [p.grad for p in opt.params if p.grad is not None])
        opt.step(metrics["grad_norm"])
        state.step += 1
        return metrics

    return train_step


def make_eval_step(eval_fn: Callable[[torch.nn.Module, dict], dict],
                   sync: BatchSync | None = None):
    """`(state, batch) -> metrics` without gradients, averaged over the
    ranks under `sync`."""
    sync = sync or BatchSync()

    def step(state: TrainState, batch: dict) -> dict:
        with torch.no_grad():
            return sync.mean(eval_fn(state.model, batch))

    return step
