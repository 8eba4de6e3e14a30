"""The bf16 flash backward at head_dim 256, on the CPU.

`flash_dq_kernel_sm90_d256` and `flash_dkv_kernel_sm90_d256`
(`hyperion_tpu_torch/ops/csrc/flash_attention.cu`) run only on the card.
Two things about them can be checked here:

* their arithmetic, emulated in torch in the kernels' order and against
  the JAX kernels in interpret mode (`_backward_tiles`): dq over 64-key
  tiles, each 16-row warp's tile taking p = exp2(s·scale·log2 e −
  lse·log2 e) where it is interior and the masked difference where it is
  an edge; p and ds rounded to bf16 as the products' A operands; dk/dv's
  p^T handed from the dv consumer to the dk consumer in fp32; every
  product's sum taken in k16 steps in key (or query) order. Held to
  2^-6 of the largest gradient, the bound of the other bf16 gradient
  tests (`tests/test_torch_flash.py`);
* their barrier protocols, as a model run under random schedules
  (`_run`): mbarriers with phases and parity waits, named barriers that
  complete on a count, TMA loads that land at any later moment. A slot
  refilled while a consumer still reads it, a hand-over read before it
  is written or after it is overwritten, and a deadlock all fail the run;
  a known-bad variant of each protocol is caught, so the model has teeth.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.ops.pallas.flash_attention import flash_attention as jflash
from hyperion_tpu_torch.ops import flash_attention as fa

LOG2E = np.float32(1.4426950408889634)
R = 64  # keys a dq tile, queries a dk/dv tile, keys a dk/dv block


def _inputs(shape=(2, 128, 2, 256), seed=25, pad_from=100):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    mask = np.ones(shape[:2], np.int8)
    mask[-1, pad_from:] = 0  # the last row's tail is padding
    return q, k, v, g, mask


def _steps16(a, b):
    """a [..., M, K] @ b [..., K, N] in fp32, summed 16 of K at a time in
    order: a wgmma chain's k16 steps."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 16):
        out = out + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def _p(s, lse, keep, inside, interior, scale):
    """p = exp(s·scale − lse) over [B, H, M, N] raw scores: the fma form
    where `interior`, the masked difference elsewhere (NEG_INF where the
    mask drops a pair, −inf outside the arrays, as `masked` in the
    kernels)."""
    sl2 = np.float32(scale) * LOG2E
    p_int = torch.exp2((s.double() * float(sl2)
                        - (lse * LOG2E).double()).float())
    x = (s * np.float32(scale)).masked_fill(~keep, fa.NEG_INF)
    x = x.masked_fill(~inside, float("-inf"))
    p_edge = torch.exp2((x - lse) * LOG2E)
    return torch.where(interior, p_int, p_edge)


def _backward_tiles(q, k, v, g, mask, causal):
    """(dq, dk, dv) of the D 256 bf16 backward kernels' arithmetic, with
    the counts of interior and edge (16-row, 64-column) pieces each used.
    [B, T, H, D] fp32 in (rounded to bf16 first), as the kernels."""
    bf = torch.bfloat16
    qb, kb, vb, gb = (torch.from_numpy(a).to(bf) for a in (q, k, v, g))
    pad = torch.from_numpy(mask)
    o, lse = fa.flash_attention_fwd_plain(qb, kb, vb, causal=causal,
                                          padding_mask=pad)
    qh, kh, vh, gh, oh = (t.float().permute(0, 2, 1, 3)
                          for t in (qb, kb, vb, gb, o))
    B, H, T, D = qh.shape
    scale = fa._scale(D)
    # delta as the dq kernel sums it: two threads a row, 128 columns each
    delta = ((gh[..., :128] * oh[..., :128]).sum(-1)
             + (gh[..., 128:] * oh[..., 128:]).sum(-1))
    rows = torch.arange(T)
    keep = pad.bool()[:, None, None, :].expand(B, H, T, T)
    if causal:
        keep = keep & (rows[None, :] <= rows[:, None])
    inside = torch.ones(T, T, dtype=torch.bool)
    # an (a 16-row warp, a 64-column tile) piece is interior when its
    # rows and columns are in range, all its keys kept, and (causal)
    # its last column at or before its warp's first row
    warp, tile = rows // 16 * 16, rows // R * R
    kept = pad.bool()  # [B, T]
    tile_kept = torch.stack([kept[:, t0:t0 + R].all(-1)
                             for t0 in range(0, T, R)], -1)  # [B, T/R]
    warp_kept = torch.stack([kept[:, w0:w0 + 16].all(-1)
                             for w0 in range(0, T, 16)], -1)  # [B, T/16]
    # dq: rows are queries (warps), columns keys (tiles)
    int_dq = tile_kept[:, None, None, rows // R].expand(B, H, T, T).clone()
    # dk/dv: rows are keys (warps), columns queries (tiles)
    int_dkv = warp_kept[:, None, rows // 16, None].expand(B, H, T, T).clone()
    if causal:
        int_dq &= (tile[None, :] + R - 1 <= warp[:, None])
        int_dkv &= (warp[:, None] + 15 <= tile[None, :])
    counts = {"dq": (int(int_dq.sum()), int((~int_dq).sum())),
              "dkv": (int(int_dkv.sum()), int((~int_dkv).sum()))}

    # dq: s = q . k^T, dp = dO . v^T; ds = p (dp - delta) to bf16; dq +=
    # ds . k in key order
    s = _steps16(qh, kh.transpose(-1, -2))
    p = _p(s, lse[..., None], keep, inside, int_dq, scale)
    dp = _steps16(gh, vh.transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(bf).float()
    dq = (_steps16(ds, kh) * np.float32(scale)).to(bf)

    # dk/dv: s^T = k . q^T on the dv consumer, p^T handed over in fp32;
    # dp^T = v . dO^T on the dk consumer; dv += bf16(p^T) . dO and dk +=
    # bf16(ds^T) . q in query order
    st = _steps16(kh, qh.transpose(-1, -2))
    pt = _p(st, lse[..., None, :], keep.transpose(-1, -2), inside.T,
            int_dkv, scale)
    dpt = _steps16(vh, gh.transpose(-1, -2))
    dst = (pt * (dpt - delta[..., None, :])).to(bf).float()
    dv = _steps16(pt.to(bf).float(), gh).to(bf)
    dk = (_steps16(dst, qh) * np.float32(scale)).to(bf)
    grads = tuple(t.permute(0, 2, 1, 3).float() for t in (dq, dk, dv))
    return grads, counts


def _jax_grads(q, k, v, g, mask, causal):
    """dq, dk, dv of the JAX kernels in interpret mode on bf16 inputs."""
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    gb = jnp.asarray(g).astype(jnp.bfloat16)

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=causal, padding_mask=jnp.asarray(mask),
                   block_q=128, block_kv=128)
        return jnp.sum((o * gb).astype(jnp.float32))

    return [np.asarray(r.astype(jnp.float32))
            for r in jax.grad(jloss, argnums=(0, 1, 2))(*jb)]


@pytest.mark.parametrize("causal", [False, True])
def test_d256_bf16_backward_order_holds_the_bf16_bound(causal):
    """The new kernels' order of sums and roundings at [2, 128, 2, 256]
    with tail padding holds the JAX kernels to 2^-6 of the largest
    gradient, over interior and edge pieces both."""
    q, k, v, g, mask = _inputs()
    got, counts = _backward_tiles(q, k, v, g, mask, causal)
    want = _jax_grads(q, k, v, g, mask, causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(a.numpy() - r).max()
        assert err <= 2.0 ** -6 * np.abs(r).max(), (name, err)
    for which in ("dq", "dkv"):
        assert min(counts[which]) > 0, counts  # both formulas ran


# ------------------------------------------------- the barrier protocols
#
# One agent a warpgroup (the consumers) or the producer warp; an arrival
# stands for all of an agent's threads, so a barrier's count is in
# agents. Agents are generators that yield the condition they wait on.


class _MBar:
    """An mbarrier: `count` arrivals and every expected transaction
    complete a phase; a wait on parity P passes once the phase of that
    parity has completed (a fresh barrier passes a wait on parity 1)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self):
        if self.pending == 0:
            raise AssertionError("arrival past a phase's count")
        self.pending -= 1
        self._flip()

    def complete_tx(self):
        self.tx -= 1
        self._flip()

    def _flip(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


class _Named:
    """A named barrier: completes (and resets) when `count` arrivals have
    come, in any mix of bar.arrive and bar.sync."""

    def __init__(self, count):
        self.count, self.arrived, self.gen = count, 0, 0

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.gen = 0, self.gen + 1


class _Slot:
    """A shared-memory buffer: the tile it holds and who reads it now."""

    def __init__(self):
        self.tile, self.readers = None, set()

    def write(self, tile):
        if self.readers:
            raise AssertionError(f"slot refilled with tile {tile} while "
                                 f"{sorted(self.readers)} read it")
        self.tile = tile

    def enter(self, who, tile):
        if self.tile != tile:
            raise AssertionError(f"{who} read tile {self.tile}, not {tile}")
        self.readers.add(who)

    def leave(self, who):
        self.readers.discard(who)


def _run(agents, rng, tma):
    """Steps every agent and every landed-at-random TMA load in a random
    order until all agents end; raises on a hazard or a deadlock."""
    waits = {name: None for name in agents}
    for name, gen in agents.items():
        waits[name] = next(gen, "done")
    while True:
        ready = [n for n, w in waits.items() if w != "done" and w()]
        choices = ready + [("tma", i) for i in range(len(tma))]
        if not choices:
            if all(w == "done" for w in waits.values()):
                return
            raise AssertionError("deadlock: " + ", ".join(
                n for n, w in waits.items() if w != "done"))
        pick = rng.choice(choices)
        if isinstance(pick, tuple):
            slot, tile, bar = tma.pop(pick[1])
            slot.write(tile)
            bar.complete_tx()
        else:
            waits[pick] = next(agents[pick], "done")


def _load(tma, bar, slot, tile):
    """arrive.expect_tx, then a TMA load that lands later."""
    bar.tx += 1
    tma.append((slot, tile, bar))
    bar.arrive()


def _dq_protocol(n_tiles, skip0, bad):
    """The dq kernel's: two k slots, one v slot; consumer 0 skips the
    tiles in `skip0` (past its causal frontier). `bad`: a skipping
    consumer releases v without waiting for it to land."""
    k_full, k_empty = [_MBar(1), _MBar(1)], [_MBar(2), _MBar(2)]
    v_full, v_empty = _MBar(1), _MBar(2)
    k_slot, v_slot, tma = [_Slot(), _Slot()], _Slot(), []

    def producer():
        for it in range(n_tiles):
            s = it & 1
            yield lambda: k_empty[s].passed(((it >> 1) & 1) ^ 1)
            _load(tma, k_full[s], k_slot[s], it)
            yield lambda: v_empty.passed((it & 1) ^ 1)
            _load(tma, v_full, v_slot, it)

    def consumer(w):
        who = f"consumer {w}"
        for it in range(n_tiles):
            s = it & 1
            yield lambda: k_full[s].passed((it >> 1) & 1)
            skip = w == 0 and it in skip0
            if not (skip and bad):
                yield lambda: v_full.passed(it & 1)
            if skip:
                v_empty.arrive()
            else:
                k_slot[s].enter(who, it)
                v_slot.enter(who, it)
                yield lambda: True  # dp, then s
                v_slot.leave(who)
                v_empty.arrive()
                yield lambda: True  # dq += ds . k
                k_slot[s].leave(who)
            k_empty[s].arrive()
            yield lambda: True

    agents = {"producer": producer(), "consumer 0": consumer(0),
              "consumer 1": consumer(1)}
    return agents, tma


def _dkv_protocol(n_tiles, bad):
    """The dk/dv kernel's: a ring of two q/dO stages, each with a p^T
    buffer that consumer 0 fills and consumer 1 reads after named barrier
    1 + stage. `bad`: one named barrier for both stages."""
    full, empty = [_MBar(1), _MBar(1)], [_MBar(2), _MBar(2)]
    stage, tma = [_Slot(), _Slot()], []
    pt = [_Slot(), _Slot()]
    named = [_Named(2), _Named(2)]

    def producer():
        for it in range(n_tiles):
            s = it % 2
            yield lambda: empty[s].passed(((it // 2) & 1) ^ 1)
            _load(tma, full[s], stage[s], it)

    def consumer(w):
        who = f"consumer {w}"
        for it in range(n_tiles):
            s = it % 2
            bar = named[0 if bad else s]
            yield lambda: full[s].passed((it // 2) & 1)
            stage[s].enter(who, it)
            yield lambda: True  # s^T (consumer 0) or dp^T (consumer 1)
            if w == 0:
                pt[s].write(it)
                bar.arrive()
            else:
                gen = bar.gen
                bar.arrive()
                yield lambda: bar.gen > gen
                pt[s].enter(who, it)
                pt[s].leave(who)
            yield lambda: True  # dv or dk product
            stage[s].leave(who)
            empty[s].arrive()

    agents = {"producer": producer(), "consumer 0": consumer(0),
              "consumer 1": consumer(1)}
    return agents, tma


def _hazards(make, runs=300, seed=0):
    """How many of `runs` random schedules of `make()`'s agents fail."""
    rng, failed = random.Random(seed), 0
    for _ in range(runs):
        agents, tma = make()
        try:
            _run(agents, rng, tma)
        except AssertionError:
            failed += 1
    return failed


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 6])
def test_dq_slots_hold_under_random_schedules(n_tiles):
    """No refill under a reader, no stale read, no deadlock, also where
    consumer 0 skips the last tile; releasing v before it lands is
    caught."""
    skip0 = {n_tiles - 1} if n_tiles > 1 else set()
    assert _hazards(lambda: _dq_protocol(n_tiles, skip0, bad=False)) == 0
    if n_tiles > 2:
        assert _hazards(lambda: _dq_protocol(n_tiles, skip0, bad=True)) > 0


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 7])
def test_dkv_hand_over_holds_under_random_schedules(n_tiles):
    """Consumer 1 reads each tile's p^T after it is written and before
    it is overwritten, and nothing deadlocks; one named barrier for both
    stages instead of one a stage is caught."""
    assert _hazards(lambda: _dkv_protocol(n_tiles, bad=False)) == 0
    if n_tiles > 2:
        assert _hazards(lambda: _dkv_protocol(n_tiles, bad=True)) > 0
