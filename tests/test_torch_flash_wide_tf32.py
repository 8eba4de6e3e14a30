"""The fp32 flash kernels past head_dim 256, on the CPU.

`flash_{fwd,dq,dkv}_kernel_wide_tf32`
(`hyperion_tpu_torch/ops/csrc/flash_attention_wide.cu`) run only on the
card. Three things about them can be checked here:

* their arithmetic, as a torch model (`_model_fwd`, `_model_bwd`): D cut
  into the slices `wide_plan` gives the cluster's blocks, each block's
  partial logits (s, and dp in the backward) over its slices (one up to
  D 2048, every 16th past it) as the three TF32 terms lo·hi + hi·lo +
  hi·hi of `split_tf32`, the partials summed in rank order, and every
  product of the softmax's side (p·v, ds·k, p^T·dO, ds^T·q) in the same
  three terms. Held to the plain versions within
  `chip_smoke.flash_close`'s fp32 bounds times `fp32_flash_growth(D)`,
  the bounds the card holds the kernels to, at D 264, 301, 320, 512,
  1032, 1928, 2056 and 2305, causal with a ragged key padding and full;
* their cluster exchange, as a model run under random schedules
  (`_run_cluster`): every warp of every block writes its partial into a
  slot of its block's buffer of the tile's parity, arrives at and waits
  on the cluster barrier, then reads its slot of every block; in dq and
  dk/dv the two warps of a row group then hand their sums over through
  their block's buffer of the other parity. A slot refilled while a warp
  reads it, a read of another tile's partial and a deadlock all fail
  the run; one buffer instead of two (a slot reused one barrier too
  early) is caught;
* their launch plan at every D from 257 to 4352: the slices cover D
  exactly, the cluster stays within 16 blocks (8, the portable size, up
  to D 1024), one pass up to 2048 and past it as many as give every
  slice a writer. (Shared memory is the same at every D; the card's
  tests read it from the compiled kernels.)
"""

from __future__ import annotations

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.ops import flash_attention as fa
from hyperion_tpu_torch.ops.attention import NEG_INF

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

SHAPE = (2, 96, 2)  # B, T, H


def _mm3(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """einsum(eq, x, y) as the kernels' three TF32 terms, each product of
    two TF32 values exact in fp32, the terms summed small ones first."""
    xh, xl = fa.split_tf32(x)
    yh, yl = fa.split_tf32(y)
    return (torch.einsum(eq, xl, yh) + torch.einsum(eq, xh, yl)) \
        + torch.einsum(eq, xh, yh)


def _blocks(D: int) -> list[list[tuple[int, int]]]:
    """The slices of D each block of the cluster sums over, in order, by
    rank."""
    plan = fa.wide_plan(D)
    C = plan["cluster"]
    return [plan["slices"][r::C] for r in range(C)]


def _over_slices(eq: str, x, y, D: int) -> torch.Tensor:
    """The cluster's sum: each block's partial over its slices of D, added
    in rank order."""
    total = None
    for slices in _blocks(D):
        part = None
        for c0, c1 in slices:
            t = _mm3(eq, x[..., c0:c1], y[..., c0:c1])
            part = t if part is None else part + t
        total = part if total is None else total + part
    return total


def _masked(s, causal, mask):
    T = s.shape[-1]
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None] & mask.bool()[:, None, None, :]
    return s.masked_fill(~keep, NEG_INF)


def _model_fwd(q, k, v, causal, mask):
    D = q.shape[-1]
    s = _masked(_over_slices("bqhd,bkhd->bhqk", q, k, D) * fa._scale(D),
                causal, mask)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = _mm3("bhqk,bkhd->bqhd", p, v) / l.permute(0, 2, 1, 3)
    return o, (m + torch.log(l)).squeeze(-1)


def _model_bwd(q, k, v, o, lse, g, causal, mask):
    D = q.shape[-1]
    scale = fa._scale(D)
    s = _masked(_over_slices("bqhd,bkhd->bhqk", q, k, D) * scale, causal,
                mask)
    p = torch.exp(s - lse[..., None])
    dp = _over_slices("bqhd,bkhd->bhqk", g, v, D)
    delta = sum(sum((g[..., c0:c1] * o[..., c0:c1]).sum(-1)
                    for c0, c1 in slices) for slices in _blocks(D))
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = _mm3("bhqk,bkhd->bqhd", ds, k) * scale
    dk = _mm3("bhqk,bqhd->bkhd", ds, q) * scale
    dv = _mm3("bhqk,bqhd->bkhd", p, g)
    return dq, dk, dv


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((*SHAPE, D))
                                   .astype(np.float32)) for _ in range(4))
    lengths = rng.integers(SHAPE[1] // 4, SHAPE[1] + 1, SHAPE[0])
    mask = torch.from_numpy((np.arange(SHAPE[1])[None] < lengths[:, None])
                            .astype(np.int8))
    return q, k, v, g, mask


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [264, 301, 320, 512, 1032, 1928, 2056, 2305])
def test_cluster_arithmetic_holds_the_card_bounds(D, causal):
    """o, lse, dq, dk and dv of the model against the plain versions
    (the backward of both from the model's o and lse, as the card's check
    takes the kernels'), within `flash_close`'s fp32 bounds at D."""
    q, k, v, g, mask = _inputs(D, seed=D + causal)
    if not causal:
        mask = torch.ones_like(mask)
    kw = dict(causal=causal, padding_mask=mask)
    o, lse = _model_fwd(q, k, v, causal, mask)
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    got = {"o": (o, ro), "lse": (lse, rlse)}
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, **kw)
    for name, a, r in zip(("dq", "dk", "dv"),
                          _model_bwd(q, k, v, o, lse, g, causal, mask), refs):
        got[name] = (a, r)
    for name, (a, r) in got.items():
        ok, err = cs.flash_close(a, r, torch.float32, name, D)
        assert ok, (name, err)


# ------------------------------------------------ the cluster exchange
#
# One agent a warp of a block; an arrival on the cluster barrier stands
# for the warp's 32 threads, so its count is blocks x warps. Agents are
# generators that yield the condition they wait on.


class _ClusterBar:
    """barrier.cluster: completes (and starts the next phase) when all
    `count` agents have arrived; a wait passes once the phase the agent
    arrived in has completed."""

    def __init__(self, count):
        self.count, self.arrived, self.phase = count, 0, 0

    def arrive(self):
        self.arrived += 1
        phase = self.phase
        if self.arrived == self.count:
            self.arrived, self.phase = 0, self.phase + 1
        return phase


class _Named:
    """A block's barrier (bar.sync): completes when `count` agents
    arrive."""

    def __init__(self, count):
        self.count, self.arrived, self.gen = count, 0, 0

    def arrive(self):
        gen = self.gen
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.gen = 0, self.gen + 1
        return gen


class _Slot:
    """A warp's fragments in shared memory: what it holds and who reads
    it now."""

    def __init__(self):
        self.tile, self.readers = None, set()

    def write(self, tile):
        if self.readers:
            raise AssertionError(f"slot refilled with {tile} while "
                                 f"{sorted(self.readers)} read it")
        self.tile = tile

    def enter(self, who, tile):
        if self.tile != tile:
            raise AssertionError(f"{who} read {self.tile}, not {tile}")
        self.readers.add(who)

    def leave(self, who):
        self.readers.discard(who)


def _cluster_protocol(kernel, blocks, n_tiles, skip, buffers):
    """The wide fp32 kernels' exchange: `blocks` blocks of 8 warps; each
    warp writes its partial into its slot of its block's buffer of the
    tile's parity, takes the cluster barrier, then reads its slot of
    every block in rank order, one read a step; dq's and dk/dv's warps w
    and w + 4 (one row group) then hand a sum over through their own
    block's buffer of the other parity (dq: both ways; dk/dv: p^T from w
    to w + 4), with a barrier of the pair between. A block barrier ends
    each tile but the last; a last cluster barrier before exit. A warp
    skips the tiles in `skip(w)` (past its causal frontier: no write, no
    read, the barriers still taken). `buffers`: 2, or 1 (every slot
    reused one barrier too early)."""
    warps = 8
    bar = _ClusterBar(blocks * warps)
    block_bar = [_Named(warps) for _ in range(blocks)]
    pair_bar = [[_Named(2) for _ in range(4)] for _ in range(blocks)]
    slots = [[[_Slot() for _ in range(warps)] for _ in range(buffers)]
             for _ in range(blocks)]

    def warp(r, w):
        who = f"block {r} warp {w}"
        for it in range(n_tiles):
            active = it not in skip(w)
            buf, spare = it % buffers, (it + 1) % buffers
            if active:
                yield lambda: True  # the partial product
                slots[r][buf][w].write(it)
            phase = bar.arrive()
            yield lambda: bar.phase > phase
            if active:
                for src in range(blocks):
                    slot = slots[src][buf][w]
                    slot.enter(who, it)
                    yield lambda: True
                    slot.leave(who)
                if kernel != "fwd":
                    gives = kernel == "dq" or w < 4
                    takes = kernel == "dq" or w >= 4
                    if gives:
                        slots[r][spare][w].write(("hand", it))
                    pb = pair_bar[r][w % 4]
                    gen = pb.arrive()
                    yield lambda: pb.gen > gen
                    if takes:
                        slot = slots[r][spare][w ^ 4]
                        slot.enter(who, ("hand", it))
                        yield lambda: True
                        slot.leave(who)
                yield lambda: True  # the output product
            if it + 1 < n_tiles:
                bb = block_bar[r]
                gen = bb.arrive()
                yield lambda: bb.gen > gen
        phase = bar.arrive()
        yield lambda: bar.phase > phase

    return {(r, w): warp(r, w) for r in range(blocks) for w in range(warps)}


def _run_cluster(agents, rng):
    """Steps every agent in a random order until all end; raises on a
    hazard or a deadlock."""
    waits = {name: next(gen, "done") for name, gen in agents.items()}
    while True:
        ready = [n for n, w in waits.items() if w != "done" and w()]
        if not ready:
            if all(w == "done" for w in waits.values()):
                return
            raise AssertionError("deadlock")
        pick = rng.choice(ready)
        waits[pick] = next(agents[pick], "done")


def _cluster_hazards(make, runs=40, seed=0):
    rng, failed = random.Random(seed), 0
    for _ in range(runs):
        try:
            _run_cluster(make(), rng)
        except AssertionError:
            failed += 1
    return failed


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("blocks,n_tiles", [(2, 1), (3, 4), (4, 5)])
def test_cluster_exchange_holds_under_random_schedules(kernel, blocks,
                                                       n_tiles):
    """No slot refilled under a reader, no read of another tile's partial
    or hand-over, no deadlock, also where warps 0 and 4 skip the last
    tile; one buffer for both tile parities is caught."""
    skip = (lambda w: {n_tiles - 1} if w % 4 == 0 and n_tiles > 1
            else set())
    good = lambda: _cluster_protocol(kernel, blocks, n_tiles, skip, 2)
    assert _cluster_hazards(good) == 0
    if n_tiles > 2:
        bad = lambda: _cluster_protocol(kernel, blocks, n_tiles, skip, 1)
        assert _cluster_hazards(bad) > 0


# ----------------------------------------------------------- the plan


def test_wide_plan_covers_every_head_dim():
    """At every D from 257 to 4352 the slices are whole 8-column groups
    but the last, at most 128 wide, none empty, and cover D exactly. Up
    to 2048 the cluster is ceil(D / 128) blocks, one a slice, at most 8
    (portable) up to D 1024, in one pass; past it the cluster is 16 and
    the passes the fewest that give every slice a block to write it. Up
    to 256 the plan refuses."""
    for D in range(257, 4353):
        plan = fa.wide_plan(D)
        C, sw, slices = plan["cluster"], plan["slice"], plan["slices"]
        P = plan["passes"]
        assert slices[0][0] == 0 and slices[-1][1] == D
        assert sw % 8 == 0 and sw <= 128
        for (a0, a1), (b0, _) in zip(slices, slices[1:]):
            assert a1 == b0 and a1 - a0 == sw
        assert all(c0 % 8 == 0 and 0 < c1 - c0 <= sw for c0, c1 in slices)
        assert C <= 16 and (C <= 8) == (D <= 1024)
        if D <= 2048:
            assert C == -(-D // 128) == len(slices) and P == 1
        else:
            assert C == 16 and sw == 128
            assert (P - 1) * C < len(slices) <= P * C
    for D in (1, 256):
        with pytest.raises(ValueError, match="fp32 wide flash kernels"):
            fa.wide_plan(D)
