"""GPipe pipeline parallelism over the mesh's `pipe` axis —
`gpipe_apply` and `gpipe_apply_layers` of
`hyperion_tpu/parallel/pipeline.py`, the schedule written by hand
(`torch.distributed.pipelining` runs its own schedules over its own
stage modules, not this stacked layout).

Each rank of the pipe group is one stage and holds its own slice of the
stacked parameters ([1, lps, ...] of the [S, lps, ...] leaves). The
schedule runs S + M - 1 ticks (S stages, M microbatches of the batch):
at tick t stage s computes microbatch t - s, and the activations hop one
stage downstream by point-to-point (`parallel.collectives.shift_`) after
every tick but the last. Stage 0 feeds from the microbatched input, the
last stage writes the output buffer. Bubble ticks (t - s outside [0, M))
compute nothing: they send zeros, which no stage writes anywhere, as the
reference's bubble results are never written. The output is the last
stage's buffer, broadcast over the group, so every stage returns the
same [B, ...] (the reference's out[-1], replicated over `pipe`).

The backward runs the schedule in reverse, by hand (`_GPipe`, the
transpose JAX derives for its `lax.scan` of ppermutes): the output's
gradient is summed onto the last stage, then for t = S + M - 2 ... 0
each stage receives from downstream the gradient of what it sent at
tick t (the reverse shift), recomputes its tick-t stage from the saved
input (dropout from the generator state saved at that tick) and takes
the gradients of the input and of the stage's parameters with
`torch.autograd.grad`; the input's goes upstream at the next backward
tick, stage 0's into the input's gradient. So the stage activations are
rematerialized in the backward, as the reference's remat policy does
per layer, and every collective inside a stage (the per-layer gathers
of `gpipe_apply_layers`) runs again in the recompute, matched across
the group's ranks, which share a pipe coordinate and so a schedule.

The reference's `gpipe_apply_layers` (FSDP within a stage) is
`gpipe_apply` with a stage function that gathers each layer: the
stage's leaves stay split over `fsdp` (and `model`) and each layer's
leaves are all-gathered right before the layer runs (`gather_layer`),
freed after; the gather's backward sums the gradient over the fsdp
ranks (a reduce-scatter) and takes each tensor-parallel rank's own
piece, since those ranks compute the same stage.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as tdist

from hyperion_tpu_torch.parallel.collectives import (
    _peer,
    all_gather,
    all_reduce_,
    group_rank,
    group_size,
    shift_,
)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, M, extras, generator, x, *params):
        S, s = group_size(group), group_rank(group)
        B = x.shape[0]
        xs = x.reshape(M, B // M, *x.shape[1:])
        out = torch.zeros_like(xs)
        ticks = S + M - 1
        state = torch.zeros_like(xs[0])
        saved_in, rng = {}, {}
        with torch.no_grad():
            for t in range(ticks):
                m = t - s
                if 0 <= m < M:
                    x_in = xs[m] if s == 0 else state
                    saved_in[t] = x_in
                    if generator is not None:
                        rng[t] = generator.get_state()
                    y = stage_fn(list(params), x_in, [e[m] for e in extras],
                                 m)
                    if s == S - 1:
                        out[m] = y
                else:
                    y = torch.zeros_like(state)  # a bubble: never written
                if t < ticks - 1:
                    state = shift_([y], group)[0]
            if S > 1:  # the last stage's output on every stage
                tdist.broadcast(out, _peer(group, S - 1), group=group)
        ctx.stage_fn, ctx.group, ctx.M, ctx.extras = stage_fn, group, M, extras
        ctx.generator, ctx.saved_in, ctx.rng = generator, saved_in, rng
        ctx.x_shape = x.shape
        ctx.save_for_backward(*params)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        group, M, extras = ctx.group, ctx.M, ctx.extras
        params = ctx.saved_tensors
        S, s = group_size(group), group_rank(group)
        ticks = S + M - 1
        B = ctx.x_shape[0]
        g_out = all_reduce_(g.reshape(M, B // M, *ctx.x_shape[1:]), group)
        g_x = torch.zeros_like(g_out)
        g_params = [None] * len(params)
        g_next = torch.zeros_like(g_out[0])  # d(input of tick t+1)
        end_state = (ctx.generator.get_state()
                     if ctx.generator is not None else None)
        for t in reversed(range(ticks)):
            m = t - s
            # what this stage sent at tick t fed the next stage's tick t+1
            g_y = (shift_([g_next], group, -1)[0] if t < ticks - 1
                   else torch.zeros_like(g_next))
            g_next = torch.zeros_like(g_next)
            if not 0 <= m < M:
                continue
            if s == S - 1:
                g_y = g_y + g_out[m]
            if ctx.generator is not None:
                ctx.generator.set_state(ctx.rng[t])
            with torch.enable_grad():
                x_in = ctx.saved_in[t].detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(p.requires_grad)
                      for p in params]
                y = ctx.stage_fn(ps, x_in, [e[m] for e in extras], m)
                wrt = [x_in] + [p for p in ps if p.requires_grad]
                grads = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
            it = iter(grads[1:])
            for i, p in enumerate(ps):
                if not p.requires_grad:
                    continue
                gp = next(it)
                if gp is not None:
                    g_params[i] = gp if g_params[i] is None \
                        else g_params[i] + gp
            g_in = grads[0] if grads[0] is not None \
                else torch.zeros_like(x_in)
            if s == 0:
                g_x[m] = g_in
            else:
                g_next = g_in
        if end_state is not None:
            ctx.generator.set_state(end_state)
        g_params = [torch.zeros_like(p) if gp is None and p.requires_grad
                    else gp for p, gp in zip(params, g_params)]
        return (None, None, None, None, None, g_x.reshape(ctx.x_shape),
                *g_params)


def gpipe_apply(stage_fn: Callable, params: list[torch.Tensor],
                x: torch.Tensor, group, *, n_microbatches: int,
                extras: list[torch.Tensor] | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Run `x` [B, ...] through the S-stage pipeline over `group` (the
    pipe axis's process group; this rank is stage `group_rank`); returns
    the last stage's [B, ...] output on every stage.

    `stage_fn(params, x_mb, extras_mb, m) -> y_mb` applies this rank's
    stage to microbatch m (same shape out as in); `params` are the
    tensors it reads that take gradients (this stage's local slices),
    handed back to it in the same order (detached copies in the
    backward's recompute). `extras`: [B, ...] side inputs (padding
    masks) split by microbatch, no gradient. `generator`: the dropout
    generator, whose state each tick's recompute restores."""
    B = x.shape[0]
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    extras = [e.reshape(M, B // M, *e.shape[1:]) for e in extras or []]
    return _GPipe.apply(stage_fn, group, M, extras, generator, x, *params)


def gather_layer(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """One layer's leaf, gathered whole from this rank's piece `t` of a
    stage leaf (`parallel.partition.apply_stacked`: a DTensor over
    `mesh`, its submesh of pipe and, per its layout, fsdp and model):
    all-gathered over the fsdp group (the backward sums over those
    ranks) and the model group (each rank keeps its own piece), along
    the layer's dims (the stage leaf's minus the two stacking dims)."""
    from hyperion_tpu_torch.runtime.mesh import AxisName

    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, placements)):
        if name == AxisName.PIPE or mesh.size(i) == 1:
            continue
        t = all_gather(t, mesh.get_group(i), dim=pl.dim - 2,
                       replicated=name == AxisName.MODEL)
    return t
