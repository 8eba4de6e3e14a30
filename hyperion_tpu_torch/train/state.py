"""Train state and optimizer — `hyperion_tpu/train/state.py:54-105`.

`make_optimizer` is optax's chain as the reference builds it —
`clip_by_global_norm` (when `grad_clip_norm > 0`), then `adamw` with the
learning rate a schedule of the update count — over a
`torch.optim.AdamW`:

  * AdamW with b1 0.9, b2 0.999, eps 1e-8 and decoupled weight decay:
    torch's `p *= 1 - lr*wd; p -= lr * m_hat / (sqrt(v_hat) + eps)` is
    optax's `p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`;
  * clipping scales every gradient by `max_norm / ||g||` when the
    global norm reaches `max_norm`, as optax does (`g / ||g|| *
    max_norm`), with no host sync;
  * the schedules (`constant`, `cosine`, `warmup_cosine`) are functions
    of the number of updates already applied, equal to optax's
    `cosine_decay_schedule` and `warmup_cosine_decay_schedule`; the
    learning rate is set before each update.

The optimizer takes the parameters that require a gradient and no
others. That is how the Llama trainer's LoRA mode freezes the base, the
reference's `optax.multi_transform` with `set_to_zero` on the base
(`hyperion_tpu/train/trainer.py:1209-1219`): the base weights have
`requires_grad=False`, so they get no gradient, no AdamW state and no
update, and the clipping norm is taken over the adapters alone, as the
reference's partitioned chain takes it over its "train" subtree.

The reference's sharded-state planning (meshes, FSDP) waits for the
distributed runtime (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda count: lr


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)."""
    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                             + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear init → peak over
    `warmup_steps`, then cosine peak → end over the remaining
    `decay_steps - warmup_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        return decay(count - warmup_steps)
    return schedule


def make_schedule(learning_rate: float, schedule: str = "constant",
                  warmup_steps: int = 0,
                  total_steps: int = 0) -> Callable[[int], float]:
    """The reference's schedule selection and its errors."""
    if schedule == "constant":
        return constant_schedule(learning_rate)
    if schedule not in ("cosine", "warmup_cosine"):
        raise ValueError(f"unknown schedule {schedule!r} "
                         "(constant | cosine | warmup_cosine)")
    if total_steps <= 0:
        raise ValueError(f"schedule {schedule!r} needs total_steps > 0 "
                         f"(got {total_steps})")
    if schedule == "cosine":
        return cosine_decay_schedule(learning_rate, total_steps)
    if warmup_steps <= 0:
        raise ValueError(
            "warmup_cosine needs warmup_steps > 0 (a zero warmup silently "
            "degenerates into plain cosine — use schedule='cosine')")
    return warmup_cosine_decay_schedule(
        0.0, learning_rate, min(warmup_steps, total_steps - 1), total_steps)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


class Optimizer:
    """The optax chain over `params`: `step()` clips the gradients in
    place, sets the scheduled learning rate and applies one AdamW
    update."""

    def __init__(self, params, learning_rate: float, weight_decay: float,
                 grad_clip_norm: float, b1: float, b2: float,
                 schedule: Callable[[int], float]):
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip_norm = grad_clip_norm
        self.schedule = schedule
        self.count = 0  # updates applied, the schedule's argument
        self.adamw = torch.optim.AdamW(self.params, lr=learning_rate,
                                       betas=(b1, b2), eps=1e-8,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, norm: torch.Tensor | None = None) -> None:
        """One update. `norm`: the gradients' global norm, when the
        caller has already computed it (the train step records it)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip_norm and self.grad_clip_norm > 0 and grads:
            if norm is None:
                norm = global_norm(grads)
            scale = torch.where(norm < self.grad_clip_norm,
                                torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1


def make_optimizer(params, learning_rate: float, weight_decay: float = 0.0,
                   grad_clip_norm: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0) -> Optimizer:
    """AdamW with optional global-norm clipping and an LR schedule, the
    reference's `make_optimizer` over `params`."""
    return Optimizer(params, learning_rate, weight_decay, grad_clip_norm,
                     b1, b2, make_schedule(learning_rate, schedule,
                                           warmup_steps, total_steps))


@dataclasses.dataclass
class TrainState:
    """What the reference's `TrainState` pytree holds, as live objects:
    the update count, the model (its params) and the optimizer (its
    state). `epoch_losses` is the port's addition: the per-step losses
    of an interrupted epoch's completed steps, which a mid-epoch
    checkpoint carries so that the resumed epoch's CSV row is the mean
    over all of its steps, as an uninterrupted run's is."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    epoch_losses: torch.Tensor | None = None
