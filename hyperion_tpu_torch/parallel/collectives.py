"""Collectives with autograd — the counterparts of the `lax` collectives
the JAX package's sequence, pipeline and expert axes run inside
`shard_map` (`ppermute`, `all_to_all`, `all_gather`, `psum`), as
`torch.distributed` calls over one process group each, with the
transpose JAX derives written as the backward where one is needed:

  * `shift_(tensors, group, hops)`  — every rank sends to the rank
    `hops` downstream on the ring and receives from `hops` upstream
    (`lax.ppermute` with perm (j, j+hops mod n)), point to point
    (`batch_isend_irecv`), all tensors in one batch; no autograd: the
    ring's and the pipeline's hand-written backwards shift the other
    way.
  * `all_to_all(x, group)`          — chunk j of dim 0 goes to rank j
    and rank j's chunk comes back in its place; its own transpose.
  * `all_gather(x, group, dim)`     — the ranks' pieces concatenated
    along `dim` in rank order; backward: the gradient summed over the
    ranks, each keeping its own piece (a reduce-scatter). With
    `replicated=True` (the ranks go on to compute the same thing, as
    tensor-parallel ranks do with a gathered stage) each keeps its own
    piece of its own gradient.
  * `all_reduce_sum(x, group)`      — backward: the gradients summed
    too (each rank's copy of the sum feeds its own loss).

A group of size 1 (or None) makes every one of them the identity, and
no call reaches the process group: a world-1 mesh runs the same code
as an unsharded model. Ranks are group ranks; the point-to-point calls
take the global rank of a peer (`get_global_rank`).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


def group_size(group) -> int:
    return 1 if group is None else tdist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else tdist.get_rank(group)


def _peer(group, i: int) -> int:
    return tdist.get_global_rank(group, i % tdist.get_world_size(group))


def shift_(tensors: list[torch.Tensor], group, hops: int = 1
           ) -> list[torch.Tensor]:
    """The tensors of the rank `hops` upstream (no autograd)."""
    n = group_size(group)
    if n == 1 or hops % n == 0:
        return list(tensors)
    me = group_rank(group)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(tdist.P2POp(tdist.isend, t.contiguous(),
                               _peer(group, me + hops), group))
        ops.append(tdist.P2POp(tdist.irecv, o, _peer(group, me - hops),
                               group))
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return outs


def all_to_all_(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    tdist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: chunk j goes to group rank j; out[j] is rank j's
    chunk for this rank. Self-transpose."""
    if group_size(group) == 1:
        return x
    if x.shape[0] != group_size(group):
        raise ValueError(f"all_to_all wants dim 0 = {group_size(group)} "
                         f"chunks, got {tuple(x.shape)}")
    return _AllToAll.apply(x, group)


def all_gather_(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
             for _ in range(n)]
    tdist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    out = x.clone()
    tdist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, replicated):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.replicated = replicated
        return all_gather_(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = g if ctx.replicated else all_reduce_(g, ctx.group)
        i = group_rank(ctx.group)
        return (total.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None,
                None, None)


def all_gather(x: torch.Tensor, group, dim: int = 0,
               replicated: bool = False) -> torch.Tensor:
    """The group's pieces concatenated along `dim` in rank order; the
    backward sums the gradient over the ranks (not when `replicated`)
    and keeps this rank's piece."""
    if group_size(group) == 1:
        return x
    if not x.requires_grad:
        return all_gather_(x, group, dim)
    return _AllGather.apply(x, group, dim, replicated)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group on every rank; the backward sums the
    gradients likewise."""
    if group_size(group) == 1:
        return x
    if not x.requires_grad:
        return all_reduce_(x, group)
    return _AllReduceSum.apply(x, group)
