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

Over sharded parameters (FSDP2's and tensor parallelism's DTensors,
`parallel/partition.py`) the same chain runs on each rank's shards:
`global_norm` sums each gradient's local squares, all-reduces the sums
of the sharded ones over the mesh axes they are split on (one
all-reduce per set of axes), and adds them in parameter order, so the
clip scale is the global norm's on every rank (and, at world 1,
bit-identical to the unsharded sum); the clip scales the local shards;
AdamW updates the shards, with DTensor and plain parameters in
separate groups so each runs torch's own implementation for its kind.

`plan_train_state` is the reference's `--dry-init` plan
(`hyperion_tpu/train/state.py:176`): the model built on the meta
device (shapes only), each parameter's placement from the partition
rules (`parallel/partition.py` `torch_layouts`: the pipelined LM's stage
leaves over `pipe`, the MoE experts over `expert`, besides `model` and
`fsdp`), and the bytes per device of parameters, gradients and AdamW
state at the policy's dtypes.
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


def _shard_groups(t) -> tuple:
    """The process groups of the mesh axes a DTensor is split on (size
    > 1); () for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return ()
    mesh = t.device_mesh
    return tuple(mesh.get_group(i) for i, pl in enumerate(t.placements)
                 if pl.is_shard() and mesh.size(i) > 1)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32, over every
    shard of a sharded one (see the module docstring)."""
    import torch.distributed as tdist

    from hyperion_tpu_torch.parallel.partition import local

    sq = [local(g).float().square().sum() for g in grads]
    keys = [_shard_groups(g) for g in grads]
    for key in dict.fromkeys(k for k in keys if k):
        idx = [i for i, k in enumerate(keys) if k == key]
        v = torch.stack([sq[i] for i in idx])
        for group in key:
            tdist.all_reduce(v, group=group)
        for j, i in enumerate(idx):
            sq[i] = v[j]
    return torch.sqrt(sum(sq))


class Optimizer:
    """The optax chain over `params`: `step()` clips the gradients in
    place, sets the scheduled learning rate and applies one AdamW
    update."""

    def __init__(self, params, learning_rate: float, weight_decay: float,
                 grad_clip_norm: float, b1: float, b2: float,
                 schedule: Callable[[int], float]):
        from torch.distributed.tensor import DTensor

        self.params = [p for p in params if p.requires_grad]
        self.grad_clip_norm = grad_clip_norm
        self.schedule = schedule
        self.count = 0  # updates applied, the schedule's argument
        groups = [[p for p in self.params if isinstance(p, DTensor)],
                  [p for p in self.params if not isinstance(p, DTensor)]]
        self.adamw = torch.optim.AdamW(
            [{"params": g} for g in groups if g] or self.params,
            lr=learning_rate, betas=(b1, b2), eps=1e-8,
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
            from hyperion_tpu_torch.parallel.partition import local

            for g in grads:
                local(g).mul_(scale.to(g.dtype))
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
    over all of its steps, as an uninterrupted run's is; `epoch_counts`
    likewise the sums of its count metrics (the cifar job's `correct`
    and `total`), so its accuracy column is the whole epoch's too."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    epoch_losses: torch.Tensor | None = None
    epoch_counts: dict | None = None


def plan_train_state(model: torch.nn.Module, mesh, fsdp: bool = True,
                     fsdp_min_size: int = 2**14) -> dict:
    """The memory plan of a TrainState over `model` — a model built on
    the meta device, its parameters at the policy's dtypes and with the
    `requires_grad` the trainer sets — laid out on `mesh` (an
    `AbstractMesh` plans any size; a DeviceMesh works too): global and
    per-device bytes of the parameters, their gradients and the AdamW
    state, per the port's layouts. Keys as the reference's
    `memory_plan` (`params_gb`, `opt_state_gb`, `batch_stats_gb` (a
    ResNet's BatchNorm running statistics, replicated), `param_count`,
    `params_by_dtype_gb`, `total_gb`, `per_device_gb` over parameters,
    optimizer state and batch statistics, `mesh`), plus the gradients'
    `grads_gb` and each section's per-device bytes. The AdamW state is
    the two moments of each trained parameter in its dtype and a 4-byte
    step count each (optax's one int32 count is the rounding's
    difference)."""
    from hyperion_tpu_torch.parallel.partition import model_layouts
    from hyperion_tpu_torch.runtime.mesh import AxisName, axis_sizes

    sizes = axis_sizes(mesh)
    layouts = model_layouts(model, mesh, fsdp=fsdp,
                            fsdp_min_size=fsdp_min_size)
    tot = {"params": 0, "grads": 0, "opt_state": 0}
    dev = {"params": 0.0, "grads": 0.0, "opt_state": 0.0}
    by_dtype: dict[str, int] = {}
    n_params = 0
    for name, p in model.named_parameters():
        lay = layouts[name]
        div = math.prod(sizes[a] for a, d in (
            (AxisName.MODEL, lay.model), (AxisName.FSDP, lay.fsdp),
            (AxisName.PIPE, lay.pipe), (AxisName.EXPERT, lay.expert))
            if d is not None)
        nbytes = p.numel() * p.element_size()
        n_params += p.numel()
        key = str(p.dtype).removeprefix("torch.")
        by_dtype[key] = by_dtype.get(key, 0) + nbytes
        parts = {"params": nbytes}
        if p.requires_grad:
            parts["grads"] = nbytes
            parts["opt_state"] = 2 * nbytes
        for k, v in parts.items():
            tot[k] += v
            dev[k] += v / div
        if p.requires_grad:  # the step count, replicated
            tot["opt_state"] += 4
            dev["opt_state"] += 4
    # BatchNorm's running statistics (the reference's `batch_stats`
    # collection), replicated on every device
    stats = sum(b.numel() * b.element_size() for n, b in
                model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    gb = lambda v: round(v / 1e9, 4)  # noqa: E731
    return {
        "mesh": sizes,
        "params_gb": gb(tot["params"]), "grads_gb": gb(tot["grads"]),
        "opt_state_gb": gb(tot["opt_state"]), "batch_stats_gb": gb(stats),
        "param_count": n_params,
        "params_by_dtype_gb": {k: gb(v) for k, v in sorted(by_dtype.items())},
        "total_gb": gb(tot["params"] + tot["opt_state"] + stats),
        "per_device_gb": gb(dev["params"] + dev["opt_state"] + stats),
        "params_per_device_gb": gb(dev["params"]),
        "grads_per_device_gb": gb(dev["grads"]),
        "opt_state_per_device_gb": gb(dev["opt_state"]),
    }
