"""Mixture-of-Experts FFN with expert parallelism over the mesh's
`expert` axis — `hyperion_tpu/ops/moe.py`.

The GShard/Switch formulation, operation for operation:

  * Tokens route within fixed-size groups (GShard's G dimension, default
    one group per batch row): a fp32 router, softmax, then top-k picks
    per token. `top_k_routing` turns each group's probabilities into two
    [g, E, C] tensors, `dispatch` (token n takes slot c of expert e) and
    `combine` (the same, gate-weighted), with C = ceil(k*g/E) *
    capacity_factor per group. Slots come from a cumulative count over
    the group's tokens with every k=0 pick ahead of every k=1 pick
    (Switch's order); gates are normalised over all k picks before
    capacity applies, so an overflowing pick is dropped and its share
    lost; padding tokens take no slot and get no weight. The routing is
    exact: the same one-hot dispatch and the same gate values as the
    reference for the same probabilities.
  * Dispatch and return are einsums: [G, g, E, C] x [G, g, d] →
    [G, E, C, d] token blocks, the expert FFN on them with stacked
    [E, ...] weights, and the combine back to [G, g, d].
  * Expert parallelism: with an expert group of n ranks, each rank holds
    E/n experts (the `experts/` leaves sharded on dim 0) and its own
    rows of the batch (`runtime/mesh.py` `LM_ROWS`). The [G, E, C, d]
    blocks go to their experts by one `all_to_all` over the expert
    group, and the outputs come back by a second (`parallel.
    collectives.all_to_all`, its own transpose in the backward). This
    is the token all-to-all GSPMD inserts for the reference.
  * Under a seq axis a row's positions lie on several ranks: the
    router's probabilities are all-gathered over the seq group, every
    rank routes the whole row the same way and dispatches its own
    positions, and the token blocks are summed over the group (with
    autograd) before the experts.
  * The load-balancing loss is GShard's E * sum_e f_e * P_e over the
    real tokens of the global batch (f_e the fraction whose top-1 pick
    is e, P_e the mean router probability), so with the rows sharded its
    sums are all-reduced over the row axes (the probabilities' sum with
    autograd). About 1.0 under uniform routing.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from hyperion_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    all_to_all,
    group_rank,
    group_size,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 256
    ff_dim: int = 1024
    activation: str = "gelu"
    # routing group size in tokens (GShard's G dimension); 0 = one group
    # per batch row
    group_size: int = 0

    def __post_init__(self):
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(
                f"need 1 <= top_k <= n_experts, got top_k={self.top_k} "
                f"n_experts={self.n_experts}")

    def capacity(self, n_tokens: int) -> int:
        per = -(-self.top_k * n_tokens // self.n_experts)  # ceil
        return max(1, int(per * self.capacity_factor))


def _xavier(shape: tuple, generator, device) -> torch.Tensor:
    """flax xavier_uniform over the last two dims (fan_in = shape[-2],
    fan_out = shape[-1]), leading dims a batch of independent draws."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    u = torch.rand(shape, generator=generator, device=device)
    return (2.0 * u - 1.0) * limit


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device=None) -> dict:
    """The router [d, E] and the stacked expert FFN (`wi` [E, d, f],
    `bi` [E, f], `wo` [E, f, d], `bo` [E, d]), fp32, xavier-uniform
    kernels and zero biases, in the reference's tree layout."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.ff_dim
    return {
        "router": {"kernel": _xavier((d, E), generator, device)},
        "experts": {
            "wi": _xavier((E, d, f), generator, device),
            "bi": torch.zeros(E, f, device=device),
            "wo": _xavier((E, f, d), generator, device),
            "bo": torch.zeros(E, d, device=device),
        },
    }


def top_k_routing(probs: torch.Tensor, cfg: MoEConfig, capacity: int,
                  valid: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """probs [..., N, E] → (dispatch, combine), each [..., N, E, C] in
    probs' dtype; leading dims are independent groups (the reference
    vmaps over them). `valid` [..., N] (1 = real token) keeps padding
    out of dispatch entirely."""
    E = probs.shape[-1]
    masks, gates = [], []
    p = probs
    for _ in range(cfg.top_k):
        idx = p.argmax(-1)
        mask = F.one_hot(idx, E).to(probs.dtype)          # [..., N, E]
        gates.append((probs * mask).sum(-1))               # original prob
        masks.append(mask if valid is None else mask * valid[..., None])
        p = p * (1.0 - mask)

    shape = (*probs.shape, capacity)
    dispatch = torch.zeros(shape, dtype=probs.dtype, device=probs.device)
    combine = torch.zeros(shape, dtype=probs.dtype, device=probs.device)
    gate_total = sum(gates) + 1e-9
    used = torch.zeros((*probs.shape[:-2], 1, E), dtype=probs.dtype,
                       device=probs.device)
    for mask, gate in zip(masks, gates):
        pos = mask.cumsum(-2) - mask + used               # [..., N, E]
        used = used + mask.sum(-2, keepdim=True)
        slot_f = (pos * mask).sum(-1)
        slot = slot_f.to(torch.int64)
        keep = (slot_f < capacity).to(probs.dtype)
        # a slot past capacity is kept out by `keep`; clamp it so the
        # one-hot has a class for it
        hot = F.one_hot(slot.clamp(max=capacity - 1),
                        capacity).to(probs.dtype)         # [..., N, C]
        sel = mask * keep[..., None]                      # [..., N, E]
        dispatch = dispatch + sel[..., None] * hot[..., None, :]
        combine = combine + (gate / gate_total)[..., None, None] * (
            sel[..., None] * hot[..., None, :])
    return dispatch, combine


def _act(name: str):
    return {"relu": F.relu,
            "gelu": lambda h: F.gelu(h, approximate="tanh")}[name]


def _experts(xe: torch.Tensor, w: dict, act, dtype) -> torch.Tensor:
    """The expert FFN on token blocks [G, E', C, d] with E' experts'
    stacked weights."""
    h = act(torch.einsum("gecd,edf->gecf", xe, w["wi"].to(dtype))
            + w["bi"].to(dtype)[None, :, None, :])
    ye = torch.einsum("gecf,efd->gecd", h, w["wo"].to(dtype))
    return ye + w["bo"].to(dtype)[None, :, None, :]


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            padding_mask: torch.Tensor | None = None, *,
            expert_group=None, row_groups: list | None = None,
            seq_group=None,
            stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] → (y [B, T, d], aux scalar).

    `params`: {"router": {"kernel": [d, E]}, "experts": {...}}, the
    expert leaves this rank's E/n experts (plain tensors) when
    `expert_group` has n > 1 ranks. `row_groups`: the process groups the
    batch rows are sharded over (the aux loss's sums are global over
    them). `seq_group` (a seq axis of n_s > 1 ranks): x holds this
    rank's slice of every row's positions; a routing group is the whole
    row (`group_size` 0), so the router's probabilities are gathered
    over the group to route it whole, each rank dispatches its own
    positions and the token blocks are summed over the group.
    `padding_mask` [B, T] (1 = real): pads take no capacity, count in
    neither aux term and get output 0 (the residual carries them).
    `stats`, when given, receives `routed` and `kept`: the real top-k
    picks and those that found a slot (global, detached)."""
    B, T, d = x.shape
    E, ns = cfg.n_experts, group_size(seq_group)
    if ns > 1 and cfg.group_size:
        raise ValueError("under a seq axis a routing group is one whole row "
                         f"(group_size 0), got {cfg.group_size}")
    g = cfg.group_size or T * ns
    if (B * T * ns) % g:
        raise ValueError(f"{B * T} tokens not divisible by group_size {g}")
    G, g_local = B * T * ns // g, g // ns
    capacity = cfg.capacity(g)
    xg = x.reshape(G, g_local, d)
    logits = torch.einsum("gnd,de->gne", xg.float(),
                          params["router"]["kernel"].float())
    probs_local = torch.softmax(logits, dim=-1)            # [G, g', E] fp32
    valid_local = (None if padding_mask is None else padding_mask.reshape(
        G, g_local).to(probs_local.device, torch.float32))
    probs, valid, mine = probs_local, valid_local, slice(None)
    if ns > 1:  # the whole row's routing, this rank's positions of it
        probs = all_gather(probs_local, seq_group, dim=1)
        if valid_local is not None:
            valid = all_gather(valid_local, seq_group, dim=1)
        i = group_rank(seq_group)
        mine = slice(i * g_local, (i + 1) * g_local)
    dispatch, combine = top_k_routing(probs, cfg, capacity, valid)
    dispatch_x = dispatch[:, mine].to(x.dtype)
    combine_x = combine[:, mine].to(x.dtype)

    # [G, E, C, d]; under seq each rank's positions' share, summed
    xe = all_reduce_sum(torch.einsum("gnec,gnd->gecd", dispatch_x, xg),
                        seq_group)
    act = _act(cfg.activation)
    n = group_size(expert_group)
    if n > 1:
        if E % n:
            raise ValueError(f"{E} experts not divisible by the {n}-way "
                             "expert axis")
        El = E // n
        C = capacity
        # [n, G, E/n, C, d]: chunk j holds this rank's tokens for rank
        # j's experts; back comes every rank's tokens for this rank's
        out = all_to_all(xe.reshape(G, n, El, C, d).transpose(0, 1),
                         expert_group)
        ye_mine = _experts(out.reshape(n * G, El, C, d), params["experts"],
                           act, x.dtype)
        back = all_to_all(ye_mine.reshape(n, G, El, C, d), expert_group)
        ye = back.transpose(0, 1).reshape(G, E, C, d)
    else:
        ye = _experts(xe, params["experts"], act, x.dtype)
    y = torch.einsum("gnec,gecd->gnd", combine_x, ye)

    # GShard load balance over the real tokens of the global batch
    top1 = F.one_hot(probs_local.argmax(-1), E).float()
    wt = (torch.ones((G, g_local, 1), device=x.device) if valid_local is None
          else valid_local[..., None])
    counts = torch.stack([(top1 * wt).sum((0, 1)),
                          wt.sum().expand(E)])             # no gradient
    p_sum = (probs_local * wt).sum((0, 1))
    for grp in [*(row_groups or []), seq_group]:
        counts = all_reduce_sum(counts, grp)
        p_sum = all_reduce_sum(p_sum, grp)
    denom = counts[1, 0].clamp_min(1.0)
    aux = E * ((counts[0] / denom) * (p_sum / denom)).sum()
    if stats is not None:
        with torch.no_grad():  # whole groups: the same on every seq rank
            routed = cfg.top_k * (valid.sum() if valid is not None
                                  else torch.tensor(float(G * g)))
            picked = torch.stack([routed.to(dispatch.device),
                                  dispatch.sum()])
            for grp in row_groups or []:
                picked = all_reduce_sum(picked, grp)
        stats["routed"], stats["kept"] = picked[0], picked[1]
    return y.reshape(B, T, d), aux
