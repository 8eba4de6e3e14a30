"""Slot-based continuous-batching decode engine on a paged KV pool —
`hyperion_tpu/serve/engine.py` in PyTorch.

Continuous batching (Yu et al., OSDI '22): the unit of scheduling is
one decode TICK, and membership of the batch is re-decided between
ticks. Requests arrive when they arrive and finish when they finish;
each `step()` admits queued requests into free slots (prefilling
them), advances every live slot, and routes the emissions.

  * The KV cache is a `[num_blocks, block_size]` POOL per layer
    (`models/llama.py:init_paged_cache`). A slot addresses it through
    a block table (`serve/blocks.py`): logical position p lives at
    physical block `bt[slot, p // bs]`. Memory tracks tokens actually
    held, and slots whose prompts share a prefix share the physical
    blocks outright (PagedAttention — Kwon et al., SOSP '23).
  * A radix prefix cache maps token prefixes to retained block
    chains: a shared system prompt is prefilled once and later
    requests prefill only their suffix, attending over the shared
    blocks through the table. A prompt that diverges mid-block reuses
    the agreeing positions through one copy-on-write block copy.
    With `host_cache_mb`, eviction DEMOTES a chain to host RAM
    (`serve/hostcache.py`) and a later same-prefix admission restores
    it instead of re-prefilling.
  * Admission is block-aware: the queue pops a request only when its
    block demand fits (`_can_admit`). Under `optimistic` admission the
    pool can still run dry mid-decode; the engine then PREEMPTS the
    youngest slot back to the queue head (its tokens ride along and
    re-prefill) instead of crashing.
  * Speculative decoding (`spec_k` + `serve/draft.py`) turns the tick
    into a draft/verify/accept round: a host-side draft source
    proposes up to k tokens per slot, ONE target forward over a
    `[S, k+1]` window scores them through the paged path (a [S]
    `cache_index` vector), and the longest prefix the target agrees
    with plus its own correction is emitted — 1..k+1 tokens per slot.
  * Chunked prefill (`prefill_chunk`) fills a long prompt in `[1, C]`
    segments, one per step, between decode ticks (Sarathi-Serve).
  * Overload brownout (`brownout*`) sheds doomed queued requests and
    clamps budgets; SLO burn-rate alerting (`slo_*`, `obs/slo.py`)
    raises and clears alerts from the windowed instruments.

What differs from the JAX engine. Torch runs eagerly, so the [S]
per-slot state (depth, budget, sampling params, seed) lives on the host
as numpy rows. The device surfaces — the tick, one prefill per bucket,
the spec tick, the chunk window and the COW copy — go through the
compile tier (`serve/graphs.py`): on the card one CUDA graph per surface
and shape, captured at `warmup`, whose static inputs take the host rows
each call; on the CPU eager calls. `compile_stats()` counts them under
the JAX engine's keys and the compile ledger (`obs/ledger.py`) pins the
counts after warmup, so a shape nobody warmed shows as a recompile.
Sampling, the draft acceptance and the one host fetch that fences a
tick stay outside the graphs. The KV pools are updated in place
(`index_put_`), where the JAX engine donates its buffers.

The crash and introspection planes are the reference's: the request
journal (`serve/journal.py`) write-ahead-logs admissions and tokens
and `replay_pending` recovers them, chaos hooks fire before ticks, in
token delivery and at slot admission (`testing/chaos.py`), and the tick
profiler, flight recorder, exposition payload and control verbs
(`obs/tickprof.py`, `obs/export.py`) read host state only.

Semantics contract (tests/test_torch_serve*.py pin it): at
temperature 0 a request decoded through this engine — while other
slots churn, share its blocks, or preempt around it, with or without
speculation, chunking or a host restore — emits the same tokens as
`infer/generate.generate` on the same prompt.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from hyperion_tpu_torch import resolve_device
from hyperion_tpu_torch.infer.generate import sample_token_slots
from hyperion_tpu_torch.infer.speculative import accept_draft
from hyperion_tpu_torch.obs import heartbeat as hb_mod
from hyperion_tpu_torch.obs import slo as slo_mod
from hyperion_tpu_torch.obs import trace as trace_mod
from hyperion_tpu_torch.obs.export import DEFAULT_WINDOW_S
from hyperion_tpu_torch.obs.heartbeat import host_rss_mb as hb_host_rss_mb
from hyperion_tpu_torch.obs.ledger import CompileLedger
from hyperion_tpu_torch.obs.tickprof import (
    FlightRecorder,
    TickProfiler,
    null_flight_recorder,
)
from hyperion_tpu_torch.ops import paged_attention as pa_mod
from hyperion_tpu_torch.serve.blocks import (
    BlockManager,
    RadixPrefixCache,
    SeqAlloc,
    blocks_for,
)
from hyperion_tpu_torch.serve.draft import DraftSource, NgramDraft
from hyperion_tpu_torch.serve.graphs import GraphTier
from hyperion_tpu_torch.serve.hostcache import (
    HostBlockStore,
    HotRootTracker,
    prefix_root_digest,
)
from hyperion_tpu_torch.serve.journal import MAX_REPLAYS_DEFAULT
from hyperion_tpu_torch.serve.metrics import ServeMetrics
from hyperion_tpu_torch.serve.queue import (
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    REJECT_BAD_REQUEST,
    REJECT_DRAINING,
    REJECT_POISONED,
    REJECT_SHED,
    AdmissionQueue,
    BrownoutGovernor,
    Request,
)
from hyperion_tpu_torch.utils.clock import SYSTEM as _CLOCK

_SNAPSHOT_EVERY = 32  # ticks between metric snapshots on the stream

# `_admit`'s third outcome: the slot was claimed but prefill proceeds
# in chunks across later steps (distinct from None = allocation race,
# which requeues). No token exists yet; the caller just moves on.
_CHUNK_ADMIT = object()

# host payloads are a pool block's raw bits: an integer dtype of the
# pool dtype's width (numpy has no bfloat16)
_RAW_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


# --- the device surfaces ------------------------------------------------
# Two bodies run on the device, each through the compile tier
# (serve/graphs.py): the model forward, which the tick, the spec tick,
# every prefill bucket and the chunk window run at their own shapes,
# and the COW block copy. The `_*_impl` functions are the host halves
# that read a forward's logits: sampling, acceptance and the state rows.

def _forward_body(model, cache):
    """ids [B, T] at per-row start positions [B] through block tables
    [B, MB], writing K/V into `cache` in place -> fp32 logits [B, T, V].
    Every input is a tensor on the model's device, so the body captures
    whole into a CUDA graph."""
    def forward(ids, start, bt):
        logits, _ = model(ids, cache=cache, cache_index=start,
                          block_tables=bt)
        return logits
    return forward


def _copy_body(cache):
    """Whole-block K/V copy (copy-on-write fork): block dst [n] becomes a
    private duplicate of src [n], which the writer may overwrite from its
    divergence offset on. In place: the pools keep their storage."""
    def copy(src, dst):
        for layer in cache:
            for kv in ("k", "v"):
                layer[kv][dst] = layer[kv][src]
    return copy


def _tick_impl(eos_id, pad_id, logits, st, live):
    # every live slot advanced one token through the forward: it wrote
    # last_token's K/V at its own depth through its block-table row and
    # attended its own filled prefix; sample with its own params. Dead
    # lanes (freed or preempted — `live` is the host slot table as a
    # mask) still computed but wrote to the null block and emit pad.
    act = st["active"] & live
    nxt = sample_token_slots(
        logits[:, 0], np.where(act, st["temperature"], 0.0),
        st["top_k"], st["top_p"], st["seeds"], st["lengths"])
    nxt = nxt.to(torch.int32).cpu().numpy()  # the host fetch is the fence
    nxt = np.where(act, nxt, np.int32(pad_id))
    adv = act.astype(np.int32)
    st["generated"] += adv
    st["lengths"] += adv
    hit_eos = (nxt == eos_id) if eos_id is not None else np.zeros_like(act)
    finished = act & (hit_eos | (st["generated"] >= st["budget"]))
    st["last_token"] = np.where(act, nxt, st["last_token"]).astype(np.int32)
    st["active"] = act & ~finished
    return nxt, finished


def _spec_tick_impl(eos_id, pad_id, logits, st, live, drafts):
    # the speculative tick: every live slot advances 1..k+1 tokens from
    # ONE target forward. The verify window [last_token, d_1..d_k] wrote
    # K/V at positions lengths..lengths+k through each slot's
    # block-table row, and row i's logits predict position
    # lengths+i+1. Rejected positions hold stale K/V that the causal
    # mask keeps invisible until a later window overwrites them.
    act = st["active"] & live
    S, k = drafts.shape
    dev = logits.device
    # t[s, i] = the token the SEQUENTIAL tick would emit at position
    # lengths[s]+i given this window prefix: all S*(k+1) rows in one
    # call, each drawn at that position, so a seeded stream does not
    # depend on whether its drafts hit or miss
    def per_row(a):
        return np.repeat(a, k + 1)

    pos = st["lengths"][:, None] + np.arange(k + 1, dtype=np.int32)
    t_arr = sample_token_slots(
        logits.reshape(S * (k + 1), -1),
        per_row(np.where(act, st["temperature"], 0.0)),
        per_row(st["top_k"]), per_row(st["top_p"]), per_row(st["seeds"]),
        pos.reshape(-1))
    m, v = accept_draft(torch.as_tensor(drafts, device=dev),
                        t_arr.view(S, k + 1))
    # one [S, k+2] host fetch is the tick's fence, as in the plain tick
    mv = torch.cat([m[:, None], v], dim=1).cpu().numpy()
    m, v = mv[:, 0], mv[:, 1:]
    # emit v[:, j] iff j is within the accepted prefix (+correction),
    # within the remaining budget, with no earlier eos in the window;
    # an active row always emits >= 1
    iota = np.arange(k + 1)[None, :]
    is_eos = (v == eos_id) if eos_id is not None \
        else np.zeros(v.shape, bool)
    eos_before = np.cumsum(is_eos, axis=1) - is_eos
    remaining = st["budget"] - st["generated"]
    emit = (iota <= m[:, None]) & (iota < remaining[:, None]) \
        & (eos_before == 0) & act[:, None]
    cnt = emit.sum(axis=1).astype(np.int32)
    out = np.where(emit, v, np.int32(pad_id)).astype(np.int32)
    last_i = np.maximum(cnt - 1, 0)
    rows = np.arange(S)
    ended_eos = is_eos[rows, last_i] & (cnt > 0)
    st["generated"] += cnt
    st["lengths"] += cnt
    finished = act & (ended_eos | (st["generated"] >= st["budget"]))
    st["last_token"] = np.where(act & (cnt > 0), v[rows, last_i],
                                st["last_token"]).astype(np.int32)
    st["active"] = act & ~finished
    # accepted DRAFTS only (the correction is a normal decode token)
    return out, cnt, np.minimum(m, cnt), finished


def _prefill_impl(eos_id, logits, st, slot, start, true_len, temperature,
                  top_k, top_p, budget, seed):
    # the forward ran the UNCACHED suffix [1, Pb], bucket-padded, at
    # positions start..start+Pb-1. `start` > 0 is a prefix-cache hit:
    # positions 0..start-1 already sat in shared blocks of the row and
    # were attended, never recomputed. Pad positions beyond the table's
    # coverage wrote to the null block; pad K/V inside the tail block
    # stays masked until decode overwrites it.
    last = logits[0, true_len - 1:true_len]  # [1, V]
    # draw position = total prompt length - 1: identical whether the
    # prefix came from cache or compute, so a hit never shifts a stream
    first = int(sample_token_slots(
        last, [temperature], [top_k], [top_p], [seed],
        [start + true_len - 1])[0])
    finished = (eos_id is not None and first == eos_id) or budget <= 1
    st["lengths"][slot] = start + true_len
    st["active"][slot] = not finished
    st["last_token"][slot] = first
    st["generated"][slot] = 1
    st["budget"][slot] = budget
    st["temperature"][slot] = temperature
    st["top_k"][slot] = top_k
    st["top_p"][slot] = top_p
    st["seeds"][slot] = seed
    return first, finished


def tick_cost(mcfg, slots: int, block_size: int,
              blocks_per_row: int) -> dict[str, float]:
    """FLOPs and bytes of one decode tick at these shapes, counted from
    the shapes as the JAX engine's `cost_analysis` counts its compiled
    tick: every slot live at full depth (its window attends all
    `block_size * blocks_per_row` positions of its table).

      * FLOPs: 2 per weight per slot for every projection and the LM
        head (q, k, v, o and the gate/up/down MLP of each layer, then
        d x vocab), plus paged attention's 4 * head_dim per visible
        (query head, position) pair in each layer (`paged_attention.cost`).
      * Bytes: every projection and LM-head weight read once, the fp32
        norm weights, the S embedding rows, each layer's paged-attention
        traffic (q, the K/V the frontier covers, the output, the table
        and bases), each layer's K/V write of the new token, and the
        fp32 logits written."""
    d, H, Hkv, Dh = mcfg.d_model, mcfg.n_heads, mcfg.n_kv_heads, \
        mcfg.head_dim
    it = torch.empty((), dtype=mcfg.compute_dtype).element_size()
    layer_w = d * H * Dh + 2 * d * Hkv * Dh + H * Dh * d + 3 * d * mcfg.ff_dim
    gemm_w = mcfg.n_layers * layer_w + d * mcfg.vocab_size
    full = block_size * blocks_per_row
    pa_bytes, pa_flops = pa_mod.cost(
        slots, 1, H, Hkv, Dh, block_size, blocks_per_row,
        np.full(slots, full - 1), it)
    flops = 2.0 * slots * gemm_w + mcfg.n_layers * pa_flops
    nbytes = (gemm_w * it + (2 * mcfg.n_layers + 1) * d * 4
              + slots * d * it
              + mcfg.n_layers * (pa_bytes + 2 * slots * Hkv * Dh * it)
              + slots * mcfg.vocab_size * 4)
    return {"tick_flops": float(flops), "tick_bytes_accessed": float(nbytes)}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 4                 # S: concurrent requests in flight
    max_len: int = 0               # L: per-slot logical length (0 = model max)
    eos_id: int | None = None
    pad_id: int = 0
    queue_capacity: int = 64
    prefill_budget: int = 512      # prompt tokens admitted per round
    min_bucket: int = 8            # smallest prefill padding bucket
    snapshot_every: int = _SNAPSHOT_EVERY
    # ---- paged cache ----
    block_size: int = 16           # tokens per KV block
    num_blocks: int = 0            # pool size incl. null block (0 = auto:
    #                                slots * ceil(L/bs) + 1, the slab equivalent)
    prefix_cache: bool = True      # radix prefix reuse on/off
    # ---- tiered KV (serve/hostcache.py) ----
    # > 0 enables the host-RAM spill tier: radix eviction demotes cold
    # prefix chains to host buffers under this LRU budget, and a later
    # same-prefix admission restores them with one host->device copy
    # instead of a re-prefill. Needs the prefix cache on.
    host_cache_mb: int = 0
    # where the store serializes on drain and loads at construction
    # (empty = no persistence)
    host_cache_dir: str = ""
    # "reserve": admit only when the WORST-CASE block demand (prompt +
    # full budget, minus shared prefix) is covered — pool exhaustion is
    # impossible by accounting. "optimistic": admit on prompt-fit only
    # and preempt-to-queue when the pool runs dry.
    admission: str = "reserve"
    # ---- speculative decoding (serve/draft.py) ----
    # spec_k > 0 with a draft source turns each decode tick into a
    # draft/verify/accept round emitting 1..spec_k+1 tokens per slot
    spec_k: int = 0                # draft tokens per slot per tick (0 = off)
    draft: str = "off"             # "ngram" (self-drafting) | "off"
    # ---- SLO classes + chunked prefill ----
    # prompts whose uncached suffix exceeds `prefill_chunk` prefill in
    # [1, chunk] segments, one per step, interleaved with decode ticks
    prefill_chunk: int = 0         # 0 = one-shot prefill (off)
    interactive_weight: int = 3    # weighted-fair picks per pattern round
    batch_weight: int = 1
    batch_capacity: int = 0        # batch queue depth cap (0 = shared cap)
    batch_deadline_s: float = 0.0  # default batch deadline (0 = none)
    # ---- overload brownout (serve/queue.py:BrownoutGovernor) ----
    brownout: bool = False         # enable the governor
    brownout_depth: int = 0        # enter watermark (0 = 3/4 of capacity)
    brownout_wait_s: float = 0.0   # queue-wait p95 enter watermark (0 = off)
    brownout_clamp: int = 0        # clamp max_new_tokens while active (0 = off)
    # ---- SLO burn-rate alerting (obs/slo.py) — 0 = that target off ----
    slo_ttft_p99_ms: float = 0.0   # windowed TTFT p99 must stay under this
    slo_reject_rate: float = 0.0   # windowed reject fraction budget
    slo_availability: float = 0.0  # windowed completed/(completed+failed) floor
    slo_fast_s: float = 0.0        # fast burn window (0 = obs/slo default 60s)
    slo_slow_s: float = 0.0        # slow burn window (0 = obs/slo default 600s)
    # ---- introspection (obs/ledger.py, obs/tickprof.py) ----
    # record one decode tick's FLOPs and bytes (`tick_cost`, counted
    # from the shapes) in the warmup ledger
    ledger_costs: bool = False


@dataclasses.dataclass
class TokenEvent:
    """One emission the host routes to a transport/test."""
    request: Request
    token: int | None              # None for reject/timeout events
    finished: bool
    kind: str = "token"            # token | rejected | timed_out
    reason: str | None = None


def _tr(req) -> dict:
    """The request's fleet hop context as event attrs ({} for direct
    clients)."""
    trace = getattr(req, "trace", None)
    return {"trace": trace} if trace else {}


class Engine:
    """Continuous-batching engine over one model.

    Host-side it owns the slot table (slot index -> Request), block
    manager + radix cache, the admission queue, metrics, telemetry and
    the [S] state rows; device-side the `[num_blocks, block_size]` KV
    pools. `step()` is one scheduling round (admit -> ensure blocks ->
    tick -> route); `run()` loops it. `device` (None = cuda:0) must be
    where the model lives."""

    def __init__(
        self,
        model: Any,
        cfg: EngineConfig,
        *,
        metrics: ServeMetrics | None = None,
        tracer=None,
        heartbeat=None,
        on_event: Callable[[TokenEvent], Any] | None = None,
        journal=None,
        chaos=None,
        flight_path=None,
        device=None,
    ):
        from hyperion_tpu_torch.models.llama import (
            init_paged_cache,
            paged_cache_block_bytes,
        )

        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model is on {model.device}, engine device is {self.device}")
        self.model = model
        mcfg = model.cfg
        L = cfg.max_len or mcfg.max_len
        if L > mcfg.max_len:
            raise ValueError(
                f"engine max_len {L} exceeds model max_len {mcfg.max_len}")
        if cfg.admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or 'optimistic', "
                             f"got {cfg.admission!r}")
        if cfg.draft not in ("off", "ngram"):
            raise ValueError(
                f"draft must be 'off' or 'ngram', got {cfg.draft!r}")
        if cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {cfg.spec_k}")
        # speculation needs both a window (spec_k) and a proposer
        # (draft): either alone leaves the sequential tick in charge
        self._spec = cfg.spec_k > 0 and cfg.draft != "off"
        self._drafter: DraftSource | None = \
            NgramDraft() if self._spec else None
        bs = cfg.block_size
        self._mb = blocks_for(L, bs)          # block-table width per slot
        num_blocks = cfg.num_blocks or cfg.slots * self._mb + 1
        if num_blocks < self._mb + 1:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one worst-case "
                f"request ({self._mb} blocks + the null block); raise "
                f"--num-blocks or --block-size")
        if cfg.prefill_chunk < 0 or cfg.prefill_chunk > L:
            raise ValueError(
                f"prefill_chunk must be in [0, max_len={L}], "
                f"got {cfg.prefill_chunk}")
        self.cfg = dataclasses.replace(cfg, max_len=L, num_blocks=num_blocks)
        self.queue = AdmissionQueue(
            cfg.queue_capacity, max_total_tokens=L,
            prefill_budget=cfg.prefill_budget,
            class_weights={CLASS_INTERACTIVE: cfg.interactive_weight,
                           CLASS_BATCH: cfg.batch_weight},
            class_capacity={CLASS_BATCH: cfg.batch_capacity}
            if cfg.batch_capacity else None,
            class_deadline_s={CLASS_BATCH: cfg.batch_deadline_s}
            if cfg.batch_deadline_s else None,
        )
        self.metrics = metrics or ServeMetrics()
        self.tracer = tracer if tracer is not None else trace_mod.null_tracer()
        self.hb = heartbeat if heartbeat is not None \
            else hb_mod.null_heartbeat()
        self.chaos = chaos
        self.on_event = on_event
        # crash safety: the write-ahead request journal
        self.journal = journal
        self._journal_err_reported = False
        self._draining = False
        self._drain_deadline: float | None = None
        self._unparsed = itertools.count()
        # chunked-prefill slots: slot -> {prompt, budget, pos, resumed}.
        # While a slot chunks, its device table row stays zeroed (the
        # segments take the row from its SeqAlloc): the decode tick
        # writes K/V at lengths[slot] for every lane whatever the live
        # mask says, and a reused slot's stale state must null-route,
        # not land in the prompt's blocks mid-prefill.
        self._chunking: dict[int, dict] = {}
        # router-ordered batch-class brownout (the `class_brownout`
        # control verb): batch sheds and clamps as under the local
        # governor, interactive is never touched. Written by the
        # exporter thread, read by the engine thread; a bool flip is
        # atomic under the GIL.
        self._class_brownout = False
        self._governor: BrownoutGovernor | None = None
        if cfg.brownout:
            depth_high = cfg.brownout_depth or max(
                1, (3 * cfg.queue_capacity) // 4)
            self._governor = BrownoutGovernor(
                depth_high=depth_high, wait_high_s=cfg.brownout_wait_s)
        # SLO burn-rate alerting, evaluated from the serve loop (step
        # AND idle ticks: an alert must be able to clear while the
        # engine sits idle after load drops)
        self.slo = None
        targets = slo_mod.standard_targets(
            cfg.slo_ttft_p99_ms, cfg.slo_reject_rate, cfg.slo_availability)
        if targets:
            self.slo = slo_mod.SLOMonitor(
                targets, self.metrics.reg,
                fast_s=cfg.slo_fast_s or slo_mod.DEFAULT_FAST_S,
                slow_s=cfg.slo_slow_s or slo_mod.DEFAULT_SLOW_S,
                clock=self.metrics.reg.clock)
        self._slots: list[Request | None] = [None] * cfg.slots
        self._seqs: list[SeqAlloc | None] = [None] * cfg.slots
        self.mgr = BlockManager(num_blocks, bs)
        self.prefix = RadixPrefixCache(self.mgr) if cfg.prefix_cache else None
        # tiered KV: the host-RAM spill tier behind the radix cache —
        # eviction demotes, admission restores
        self.host: HostBlockStore | None = None
        self._hot_roots = HotRootTracker()
        if cfg.host_cache_mb > 0 and self.prefix is not None:
            self.host = HostBlockStore(
                cfg.host_cache_mb, bs,
                dtype=str(mcfg.compute_dtype).removeprefix("torch."))
            self.prefix.spill = self._spill_block
            if cfg.host_cache_dir:
                n_loaded = self.host.load(cfg.host_cache_dir)
                if n_loaded:
                    self.tracer.event(
                        "hostcache_loaded", chains=n_loaded,
                        mb=round(self.host.occupancy_mb, 3),
                        path=cfg.host_cache_dir)
            # an enabled-but-cold tier reads 0, not absent
            self.metrics.observe_host_cache(
                self.host.occupancy_mb, len(self.host))
        self._bt = np.zeros((cfg.slots, self._mb), np.int32)
        self._pending_reserve: dict[str, int] = {}
        self._order = itertools.count()
        self._block_bytes = paged_cache_block_bytes(mcfg, bs)
        self._cache = init_paged_cache(mcfg, num_blocks, bs,
                                       device=self.device)
        self._state = self._init_state()
        self._tick_no = 0
        # model forwards run: prefills, chunk segments, ticks, spec ticks
        self.forwards = 0
        self.chunk_segments = 0  # K/V-only chunked-prefill segments run
        self._sink_s = 0.0  # cumulative transport-sink seconds
        # the compile tier: every device surface runs through it
        self.tier = GraphTier(self.device)
        self._forward = _forward_body(model, self._cache)
        self._copy = _copy_body(self._cache)
        # introspection plane: compile ledger + host-tick profiler +
        # flight recorder (all host-only — none touch the device)
        self.ledger = CompileLedger()
        self.tickprof = TickProfiler()
        # held across each tick and by an on-demand trace while the
        # profiler starts or stops (`control`), so the two never overlap
        self._tick_gate = threading.Lock()
        self.flight = (FlightRecorder(flight_path, run=self.tracer.run)
                       if flight_path else null_flight_recorder())
        self._journal_s = 0.0     # cumulative journal seconds (see _sink_s)
        self._last_prefill_bucket: int | None = None
        self._param_bytes = int(sum(
            p.numel() * p.element_size() for p in model.parameters()))

    # ------------------------------------------------------ device state

    def _init_state(self) -> dict:
        S = self.cfg.slots
        return {
            "lengths": np.zeros((S,), np.int32),
            "active": np.zeros((S,), bool),
            "last_token": np.zeros((S,), np.int32),
            "generated": np.zeros((S,), np.int32),
            "budget": np.ones((S,), np.int32),
            "temperature": np.zeros((S,), np.float32),
            "top_k": np.zeros((S,), np.int32),
            "top_p": np.ones((S,), np.float32),
            "seeds": np.zeros((S,), np.int64),
        }

    # --------------------------------------------------------- plumbing

    def bucket(self, prompt_len: int) -> int:
        """Smallest power-of-two >= prompt_len (floored at min_bucket,
        capped at max_len): the prefill window lengths."""
        b = self.cfg.min_bucket
        while b < prompt_len:
            b *= 2
        return min(b, self.cfg.max_len)

    def compile_stats(self) -> dict:
        """Graphs per device surface under the JAX engine's executable
        keys (on the CPU: the distinct surface shapes run) — the
        no-recompile guarantee made measurable: after `warmup` these
        stay flat across slot churn, prefix hits, COW forks,
        preemptions, spec ticks and chunks."""
        return self.tier.stats()

    def warmup(self, prompt_lens: list[int] | None = None) -> dict:
        """Build the tick, the COW block copy, and one prefill per
        bucket (plus the spec tick and the chunk window when on), then
        reset serving state; on the card each becomes a captured CUDA
        graph. The ladder covers every bucket a live request can reach:
        up to the largest `prompt_lens` under `reserve`, up to max_len
        under `optimistic` (a preemption resume grows the prompt), and
        up to bucket(prefill_chunk) when chunking (every sampling
        prefill is then a final segment of at most one chunk). Records
        the compile ledger and pins its baseline; returns
        `compile_stats()`."""
        want = self.bucket(max(prompt_lens or [self.cfg.min_bucket]))
        if self.cfg.admission == "optimistic":
            want = self.cfg.max_len
        if self.cfg.prefill_chunk > 0:
            want = self.bucket(self.cfg.prefill_chunk)
        lens: list[int] = []
        b = self.cfg.min_bucket
        while True:
            pb = min(b, self.cfg.max_len)
            if pb not in lens:
                lens.append(pb)
            if pb >= want:
                break
            b *= 2
        compile_s: dict[str, float] = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            fn(*args)
            compile_s[name] = round(time.perf_counter() - t0, 4)

        with self.tracer.span("serve_warmup") as sp:
            for pb in lens:
                dummy = Request(prompt_ids=np.ones((min(pb, 2),), np.int32),
                                max_new_tokens=2)
                # bt row is all-null during warmup: the dummy's writes
                # land in the garbage block, real state is untouched
                timed(f"prefill_b{pb}", lambda: self._prefill_call(
                    dummy, slot=0, bucket_len=pb))
            timed("tick", self._tick_device)
            if self._spec:
                # all-zero drafts run the shapes live traffic will
                timed("spec_tick", self._spec_tick_device,
                      np.zeros((self.cfg.slots, self.cfg.spec_k), np.int32))
            if self.cfg.prefill_chunk > 0:
                # an all-null bt row: the dummy's K/V land in the null block
                timed("chunk", self._chunk_call,
                      np.full((self.cfg.prefill_chunk,), self.cfg.pad_id,
                              np.int32),
                      np.zeros((self._mb,), np.int32), 0)
            timed("copy", self._copy_blocks, 0, 0)
            costs = tick_cost(self.model.cfg, self.cfg.slots,
                              self.cfg.block_size, self._mb) \
                if self.cfg.ledger_costs else None
            sp.set(buckets=lens)
        self._state = self._init_state()
        self._slots = [None] * self.cfg.slots
        self._seqs = [None] * self.cfg.slots
        self._chunking = {}
        self._bt[:] = 0
        stats = self.compile_stats()
        total_s = round(sp.dur_s or 0.0, 4)
        self.ledger.record_warmup(stats, compile_s=compile_s, costs=costs,
                                  total_s=total_s)
        self.ledger.set_baseline(stats)
        self.tracer.event("serve_warmup_done", **stats)
        self.tracer.event("compile_ledger", total_s=total_s,
                          compile_s=compile_s, costs=costs or {}, **stats)
        return stats

    def _prefill_call(self, req: Request, slot: int, *, start: int = 0,
                      prompt: np.ndarray | None = None,
                      budget: int | None = None,
                      bucket_len: int | None = None):
        ids = req.prompt_ids if prompt is None else prompt
        suffix = ids[start:]
        P = int(suffix.shape[0])
        Pb = bucket_len or self.bucket(P)
        self._last_prefill_bucket = Pb   # churn context for the ledger
        buf = np.full((1, Pb), self.cfg.pad_id, np.int32)
        buf[0, :P] = suffix
        self.forwards += 1
        logits = self.tier.run("prefill", self._forward, {
            "ids": buf, "start": np.array([start], np.int32),
            "bt": self._bt[slot][None]})
        return _prefill_impl(
            self.cfg.eos_id, logits, self._state, slot, start, P,
            float(req.temperature), int(req.top_k), float(req.top_p),
            int(req.max_new_tokens if budget is None else budget),
            int(req.seed))

    def _chunk_call(self, window: np.ndarray, row: np.ndarray,
                    start: int) -> None:
        # one chunked-prefill segment (Sarathi-Serve, OSDI '24): write
        # the K/V of `window`'s positions start..start+C-1 through this
        # slot's block-table row and DISCARD the logits. Sampling waits
        # for the final segment (`_prefill_impl`, drawn at the total
        # prompt length - 1), so chunking never shifts a stream
        self.forwards += 1
        self.chunk_segments += 1
        self.tier.run("chunk", self._forward, {
            "ids": window[None], "start": np.array([start], np.int32),
            "bt": row[None]})

    def _copy_blocks(self, src: int, dst: int) -> None:
        self.tier.run("copy", self._copy, {
            "src": np.array([src], np.int64),
            "dst": np.array([dst], np.int64)})

    def _live_mask(self) -> np.ndarray:
        """Slots the decode tick may advance: occupied AND not mid-chunk.
        A chunking slot's state rows are a previous occupant's leftovers
        and its table row is zeroed; the mask keeps the tick from
        decoding garbage into it."""
        return np.fromiter(
            (r is not None and s not in self._chunking
             for s, r in enumerate(self._slots)), bool, len(self._slots))

    def _tick_device(self):
        st = self._state
        self.forwards += 1
        logits = self.tier.run("tick", self._forward, {
            "ids": st["last_token"][:, None], "start": st["lengths"],
            "bt": self._bt})
        return _tick_impl(self.cfg.eos_id, self.cfg.pad_id, logits, st,
                          self._live_mask())

    def _collect_drafts(self) -> np.ndarray:
        """[S, spec_k] proposals for this tick, one drafter call per live,
        non-chunking slot over its visible context. Other lanes stay
        zero (the tick masks them out)."""
        k = self.cfg.spec_k
        drafts = np.zeros((self.cfg.slots, k), np.int32)
        for s, req in enumerate(self._slots):
            if req is not None and s not in self._chunking:
                drafts[s] = self._drafter.propose(
                    s, req.prompt_ids, req.tokens, k)
        return drafts

    def _spec_tick_device(self, drafts: np.ndarray):
        st = self._state
        self.forwards += 1
        window = np.concatenate([st["last_token"][:, None], drafts], axis=1)
        logits = self.tier.run("spec_tick", self._forward, {
            "ids": window, "start": st["lengths"], "bt": self._bt})
        return _spec_tick_impl(self.cfg.eos_id, self.cfg.pad_id, logits,
                               st, self._live_mask(), drafts)

    # --------------------------------------------------- block plumbing

    def _effective(self, req: Request) -> tuple[np.ndarray, int]:
        """(prompt, remaining budget) — preemption-aware: a preempted
        request resumes by prefilling prompt + everything it already
        generated (recompute preemption)."""
        if req.tokens:
            prompt = np.concatenate(
                [req.prompt_ids, np.asarray(req.tokens, np.int32)])
            return prompt, req.max_new_tokens - len(req.tokens)
        return req.prompt_ids, req.max_new_tokens

    def _block_demand(self, req: Request) -> int:
        """Exclusive new blocks this request needs — worst-case span
        under `reserve` admission, prompt-only under `optimistic` — net
        of blocks a radix hit would share."""
        prompt, budget = self._effective(req)
        P = int(prompt.shape[0])
        span = P + budget if self.cfg.admission == "reserve" else P
        need = blocks_for(span, self.cfg.block_size)
        if self.prefix is not None:
            need -= len(self.prefix.lookup(prompt, P - 1).blocks)
        return need

    def _can_admit(self, req: Request) -> bool:
        """Block-availability gate for the queue: pop only when the
        demand is covered by free + evictable-radix blocks, net of
        reservations already promised. Covered demand is reserved
        immediately, so one scheduling round cannot double-spend."""
        need = self._block_demand(req)
        evictable = self.prefix.evictable() if self.prefix else 0
        if need > self.mgr.num_free + evictable - self.mgr.reserved:
            return False
        self.mgr.reserve(need)
        self._pending_reserve[req.id] = need
        return True

    def _alloc(self, n: int, seq: SeqAlloc | None = None) -> list[int] | None:
        """Pool allocation with radix eviction backing; claims against
        `seq`'s reservation when it holds one."""
        blocks = self.mgr.alloc(n)
        if blocks is None and self.prefix is not None:
            freed = self.prefix.evict(n - self.mgr.num_free)
            if freed:
                self.metrics.on_evict(freed)
            blocks = self.mgr.alloc(n)
        if blocks is not None and seq is not None and seq.reserved:
            take = min(seq.reserved, n)
            seq.reserved -= take
            self.mgr.release(take)
        return blocks

    def _spill_block(self, chain_tokens: tuple[int, ...],
                     block: int) -> None:
        """Radix eviction's demotion hook (`RadixPrefixCache.spill`): the
        dying block's K/V of every layer, stacked on the device and read
        to the host in ONE copy as raw bits, go to the host tier keyed by
        the block's full chain prefix."""
        stacked = torch.stack([layer[kv][block] for layer in self._cache
                               for kv in ("k", "v")])  # [2L, bs, H, D]
        raw = stacked.view(_RAW_BITS[stacked.element_size()]).cpu().numpy()
        payload = raw.reshape(len(self._cache), 2, *raw.shape[1:])
        if self.host.put(chain_tokens, payload):
            self.metrics.on_host_spill(payload.nbytes)
            self.metrics.observe_host_cache(
                self.host.occupancy_mb, len(self.host))

    def _restore_blocks(self, blocks: list[int],
                        payloads: list[np.ndarray]) -> int:
        """The promotion half: one host->device copy of the stacked
        payloads, viewed back as the pool's dtype (bit-exact: a restored
        stream matches the never-evicted run), scattered into freshly
        allocated blocks layer by layer. Returns bytes moved."""
        stacked = np.stack(payloads)  # [n, L, 2, bs, H, D] raw bits
        pool_dtype = self._cache[0]["k"].dtype
        dev = torch.from_numpy(stacked).to(self.device).view(pool_dtype)
        ids = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for li, layer in enumerate(self._cache):
            layer["k"][ids] = dev[:, li, 0]
            layer["v"][ids] = dev[:, li, 1]
        return int(stacked.nbytes)

    def _free_slot(self, slot: int) -> None:
        seq = self._seqs[slot]
        if seq is not None:
            self.mgr.release(seq.reserved)
            self.mgr.decref(seq.blocks)
        self._seqs[slot] = None
        self._slots[slot] = None
        self._chunking.pop(slot, None)
        self._bt[slot, :] = 0

    def _admit(self, req: Request, slot: int) -> TokenEvent | None:
        """Prefill `req` into `slot` through the paged pool: radix
        lookup -> share/COW -> allocate exclusives -> prefill the suffix
        -> register prompt blocks. Returns the first-token event,
        `_CHUNK_ADMIT` when the prompt prefills in chunks over later
        steps, or None when allocation lost a race (caller requeues)."""
        reserve = self._pending_reserve.pop(req.id, 0)
        prompt, budget = self._effective(req)
        P = int(prompt.shape[0])
        bs = self.cfg.block_size
        shared: list[int] = []
        cow_src: int | None = None
        start = 0
        host_payloads: list[np.ndarray] = []
        device_start = 0
        if self.prefix is not None:
            m = self.prefix.lookup(prompt, P - 1)
            shared, start, cow_src = m.blocks, m.tokens, m.cow_src
            device_start = start
            if self.host is not None:
                # device miss -> host hit: probe the host tier for
                # full-block chain links beyond the device match. It wins
                # only when it covers MORE than the device walk (its
                # mid-block COW extension included); then the restore
                # supersedes the COW copy.
                base = len(shared) * bs
                host_payloads = self.host.match(prompt, base, P - 1)
                if host_payloads \
                        and base + len(host_payloads) * bs > start:
                    start = base + len(host_payloads) * bs
                    cow_src = None
                else:
                    host_payloads = []
        need_now = blocks_for(P, bs) - len(shared)
        # pin the matched chain (and the COW source) BEFORE allocating:
        # allocation may evict radix holds, and a trie-only block just
        # matched is exactly what LRU eviction would pick off
        pin = shared + ([cow_src] if cow_src is not None else [])
        self.mgr.incref(pin)
        fresh = self._alloc(need_now) if need_now else []
        if fresh is None:
            self.mgr.decref(pin)
            self.mgr.release(reserve)
            return None
        # re-derive the growth reservation rather than netting the
        # gate's estimate: growth demand does not depend on sharing, so
        # the reserve-mode "exhaustion impossible" ledger stays exact
        self.mgr.release(reserve)
        growth = 0
        if self.cfg.admission == "reserve":
            growth = blocks_for(P + budget, bs) - blocks_for(P, bs)
            self.mgr.reserve(growth)
        seq = SeqAlloc(
            blocks=shared + fresh, n_shared=len(shared),
            reserved=growth, order=next(self._order),
        )
        if cow_src is not None:
            # mid-block divergence: duplicate the agreeing block so our
            # writes (suffix prefill + decode) never touch the original
            self._copy_blocks(cow_src, fresh[0])
            self.mgr.decref([cow_src])  # the pin; the copy is ours now
            self.metrics.on_cow()
        if host_payloads:
            # the first len(host_payloads) fresh blocks are exactly the
            # logical positions after the device-shared span; the
            # post-prefill `prefix.insert` re-registers the whole chain
            moved = self._restore_blocks(
                fresh[:len(host_payloads)], host_payloads)
            host_tokens = len(host_payloads) * bs
            self.metrics.on_host_restore(len(host_payloads), moved)
            self.metrics.observe_host_cache(
                self.host.occupancy_mb, len(self.host))
            self.tracer.event(
                "host_restore", request=req.id, tick=self._tick_no,
                blocks=len(host_payloads), tokens=host_tokens,
                bytes=moved, **_tr(req))
        if self.prefix is not None:
            self.metrics.on_prefix_lookup(P, start)
            # under a host hit the device's share is the full-block walk
            # (the superseded COW extension never ran), so device + host
            # sum to exactly `start`
            self.metrics.on_tier_lookup(
                device_tokens=len(shared) * bs if host_payloads
                else device_start,
                host_tokens=len(host_payloads) * bs)
            self._hot_roots.note(prefix_root_digest(prompt))
        resumed = req.first_token_at is not None
        C = self.cfg.prefill_chunk
        if C > 0 and P - start > C:
            # chunked prefill: claim the slot and its blocks NOW (the
            # gate reserved them) but keep the device row zeroed until
            # the final segment installs real state; the prefix enters
            # the radix only once the blocks hold it
            self._bt[slot, :] = 0
            seq.n_filled = start
            self._slots[slot] = req
            self._seqs[slot] = seq
            self._chunking[slot] = {"prompt": prompt, "budget": budget,
                                    "pos": start, "resumed": resumed}
            self.tracer.event(
                "prefill_chunked", request=req.id, tick=self._tick_no,
                slot=slot, prompt_len=P, cached_tokens=start, chunk=C,
                segments=-(-(P - start) // C), resumed=resumed,
                **_tr(req))
            return _CHUNK_ADMIT
        return self._prefill_first(req, slot, seq, prompt, budget, start,
                                   resumed)

    def _table_row(self, blocks: list[int]) -> np.ndarray:
        row = np.zeros((self._mb,), np.int32)
        row[:len(blocks)] = blocks
        return row

    def _prefill_first(self, req: Request, slot: int, seq: SeqAlloc,
                       prompt: np.ndarray, budget: int, start: int,
                       resumed: bool, chunked: bool = False) -> TokenEvent:
        """Install the slot's table row, run the sampling prefill of
        `prompt[start:]` and register the prompt's blocks; returns the
        first-token event (the final segment of a chunked prefill lands
        here too, at the total-length draw position)."""
        P = int(prompt.shape[0])
        self._bt[slot] = self._table_row(seq.blocks)
        extra = {"chunked": True} if chunked else {}
        with self.tracer.span("serve_prefill", step=self._tick_no) as sp:
            first, finished = self._prefill_call(
                req, slot, start=start, prompt=prompt, budget=budget)
            sp.set(request=req.id, slot=slot, prompt_len=P,
                   cached_tokens=start, bucket=self.bucket(P - start),
                   resumed=resumed, **extra)
        seq.n_filled = P
        if self.prefix is not None:
            self.prefix.insert(prompt, seq.blocks)
        now = _CLOCK()
        req.prefilled_at = now
        if resumed:
            # a resume re-prefills prompt + generated: pure replay cost
            req.replay_s += sp.dur_s or 0.0
            gap_from = getattr(req, "_last_emit_at", None)
            if gap_from is not None:
                self.metrics.on_token_gap(now - gap_from, req.sla_class)
        else:
            req.prefill_s += sp.dur_s or 0.0
            req.first_token_at = now
            self.metrics.on_first_token(req, now)
            self.tracer.event(
                "request_first_token", request=req.id, tick=self._tick_no,
                ttft_s=round(now - req.submitted_at, 6),
                queue_wait_s=round(req.queue_wait_s, 6),
                gate_wait_s=round(req.gate_wait_s, 6),
                prefill_s=round(req.prefill_s, 6), **extra, **_tr(req))
        req._last_emit_at = now
        req._sink_mark = self._sink_s
        self.metrics.count_tokens(1)  # the prefill-sampled token
        self._slots[slot] = req
        self._seqs[slot] = seq
        if finished:
            self._free_slot(slot)
        return TokenEvent(req, first, finished)

    def _advance_chunks(self) -> list[TokenEvent]:
        """Run at most ONE prefill segment this step — the oldest
        chunking slot's — so long prompts interleave with decode ticks
        instead of stalling them (Sarathi-Serve's stall-free schedule).
        Intermediate segments write K/V only; the final one (suffix <=
        chunk, so its bucket is on the warmup ladder) is the sampling
        prefill from the chunk boundary, drawn at the total prompt length
        - 1 like a one-shot prefill."""
        if not self._chunking:
            return []
        C = self.cfg.prefill_chunk
        slot = min(self._chunking, key=lambda s: self._seqs[s].order)
        ck = self._chunking[slot]
        req, seq = self._slots[slot], self._seqs[slot]
        prompt, pos = ck["prompt"], ck["pos"]
        if int(prompt.shape[0]) - pos > C:
            t0 = _CLOCK()
            self._chunk_call(np.asarray(prompt[pos:pos + C], np.int32),
                             self._table_row(seq.blocks), pos)
            # fence: the segment's wall time belongs to this step
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = _CLOCK() - t0
            if ck["resumed"]:
                req.replay_s += dt
            else:
                req.prefill_s += dt
            ck["pos"] = seq.n_filled = pos + C
            return []
        del self._chunking[slot]
        return [self._prefill_first(req, slot, seq, prompt, ck["budget"],
                                    pos, ck["resumed"], chunked=True)]

    def _preempt(self, slot: int, reason: str = "pool_exhausted") -> None:
        """Push this slot's request back to the queue HEAD (recompute
        preemption — generated tokens ride along and re-prefill on
        re-admission, often from their own radix-cached prefix)."""
        req = self._slots[slot]
        self._free_slot(slot)
        self.metrics.on_preempt()
        req.preempts += 1
        req._preempted = True  # its next queue wait is replay, not FIFO
        self.tracer.event("request_preempted", request=req.id,
                          generated=len(req.tokens), tick=self._tick_no,
                          reason=reason, sla_class=req.sla_class,
                          **_tr(req))
        self.queue.push_front(req)

    def _account_pop(self, req) -> bool:
        """Bank the queue wait that ended at this pop: replay wait when
        the pop resumes a preemption, otherwise FIFO wait with the
        block-gated tail broken out. Returns whether this pop was a
        preemption resume."""
        popped = (req.admitted_at if req.admitted_at is not None
                  else _CLOCK())
        wait = max(0.0, popped - req.enqueued_at)
        gate = 0.0
        if req.gate_blocked_at is not None:
            gate = min(wait, max(0.0, popped - req.gate_blocked_at))
            req.gate_blocked_at = None
        resumed = req._preempted
        if resumed:
            req._preempted = False
            req.replay_s += wait
        else:
            req.gate_wait_s += gate
            req.queue_wait_s += wait - gate
        if self._governor is not None:
            # every completed wait (replay stints included) feeds the
            # brownout p95 window, tagged with its class for shed_doomed
            self._governor.observe_wait(wait, req.sla_class)
        self.tracer.event(
            "request_scheduled", request=req.id, tick=self._tick_no,
            resumed=resumed,
            queue_wait_s=round(0.0 if resumed else wait - gate, 6),
            gate_wait_s=round(0.0 if resumed else gate, 6),
            replay_wait_s=round(wait if resumed else 0.0, 6),
            **_tr(req))
        return resumed

    def _ensure_blocks(self) -> None:
        """Before a tick, every live slot must own the block its next
        write lands in. Allocate (evicting radix holds as needed); when
        the pool is truly dry, preempt the YOUNGEST slot (batch class
        first) and retry — the oldest request always progresses."""
        for s in sorted(
            (t for t in range(self.cfg.slots) if self._slots[t] is not None),
            key=lambda t: self._seqs[t].order,
        ):
            while self._slots[s] is not None:
                seq = self._seqs[s]
                lookahead = 0
                if self._spec:
                    # the verify window writes positions n_filled ..
                    # n_filled+k, and an ACCEPTED token must land in a
                    # real block (else it lands in the null block and the
                    # next tick reads garbage). Acceptance is capped by
                    # the remaining budget, and writes past the chain
                    # null-route harmlessly, so the lookahead stays
                    # within the reserve-mode worst-case span.
                    req = self._slots[s]
                    lookahead = max(0, min(
                        self.cfg.spec_k,
                        req.max_new_tokens - len(req.tokens) - 1))
                needed = (seq.n_filled + lookahead) \
                    // self.cfg.block_size + 1
                if len(seq.blocks) >= needed:
                    break
                got = self._alloc(1, seq)
                if got is not None:
                    self._bt[s, len(seq.blocks)] = got[0]
                    seq.blocks.append(got[0])
                    continue
                live = [t for t in range(self.cfg.slots)
                        if self._slots[t] is not None]
                batch = [t for t in live
                         if self._slots[t].sla_class == CLASS_BATCH]
                victim = max(batch or live,
                             key=lambda t: self._seqs[t].order)
                self._preempt(victim)

    # ------------------------------------------------------------ events

    def _journal_guard(self) -> None:
        """Surface a journal IO failure exactly once: the engine keeps
        serving (durability degraded beats dead), but the stream and the
        counters say so."""
        j = self.journal
        if j is not None and not j.enabled and not self._journal_err_reported:
            self._journal_err_reported = True
            self.metrics.on_journal_error()
            self.tracer.event("journal_io_error", error=j.error)
            print(f"[serve] journal disabled after IO error: {j.error} — "
                  "serving continues WITHOUT crash recovery",
                  file=sys.stderr)

    def _emit(self, ev: TokenEvent) -> None:
        req = ev.request
        if ev.kind == "token" and ev.token is not None:
            req.tokens.append(ev.token)
        if ev.finished and ev.kind == "token":
            req.status = "done"
        # journal BEFORE the sink write, flushed to the kernel inside
        # `token`/`finish` (serve/journal.py's ordering contract): any
        # token a client received is already durable, so a replay never
        # re-computes — hence never re-delivers — it
        if self.journal is not None and req._journaled:
            jt0 = _CLOCK()
            if ev.kind == "token" and ev.token is not None:
                self.journal.token(req.id, ev.token)
            if ev.finished:
                self.journal.finish(
                    req.id,
                    "done" if ev.kind in ("token", "done")
                    else (ev.reason or ev.kind))
            if ev.kind in ("token", "timed_out"):
                # engine-thread emissions only (as for _sink_s below)
                self._journal_s += _CLOCK() - jt0
            self._journal_guard()
        if self.chaos is not None:
            # the request rides along so tenant-targeted client chaos
            # (slowloris@tenant=...) can pick its victim
            self.chaos.on_client(self._tick_no, req)
        if req.sink is not None:
            t0 = _CLOCK()
            try:
                req.sink(ev)
            except Exception:  # noqa: BLE001
                # a client that died mid-stream costs ITS request, never
                # the engine: drop the sink and let the slot finish
                req.sink = None
                self.metrics.on_dropped_sink()
                self.tracer.event("client_disconnected", request=req.id,
                                  tick=self._tick_no, **_tr(req))
            dt = _CLOCK() - t0
            req.client_write_s += dt
            if ev.kind in ("token", "timed_out"):
                # engine-thread emissions only: reject writes on reader
                # threads must not pollute the decode-gap netting
                self._sink_s += dt
            self.metrics.on_client_write(dt)
        if self.on_event is not None:
            self.on_event(ev)
        if ev.finished or ev.kind != "token":
            req.finished_at = _CLOCK()
            req.done.set()

    def _on_finished(self, req) -> None:
        """Terminal accounting for a completed request: SLO metrics,
        phase histograms, and the `request_finished` event."""
        now = req.finished_at if req.finished_at is not None \
            else _CLOCK()
        self.metrics.on_finish(req, now)
        reason = ("eos" if self.cfg.eos_id is not None and req.tokens
                  and req.tokens[-1] == self.cfg.eos_id else "budget")
        req.finish_reason = reason
        self.metrics.on_phases(req)
        self.tracer.event(
            "request_finished", request=req.id, tick=self._tick_no,
            reason=reason, prompt_len=req.prompt_len,
            n_tokens=len(req.tokens), preempts=req.preempts,
            e2e_s=round(now - req.submitted_at, 6),
            ttft_s=(round(req.first_token_at - req.submitted_at, 6)
                    if req.first_token_at is not None else None),
            **{f"{p}_s": round(v, 6) for p, v in req.phases_s().items()},
            **_tr(req),
        )

    # -------------------------------------------------------- public api

    def submit(self, req: Request) -> tuple[bool, str | None]:
        """Queue a request (thread-safe). Rejections emit immediately —
        backpressure the caller can act on, not a silent drop."""
        gov = self._governor
        gov_active = gov is not None and gov.active
        # batch clamps whenever any brownout holds; interactive only
        # when the local governor is active AND the batch queue is
        # already empty: batch absorbs every degradation first
        clamp_this = (gov_active or self._class_brownout) \
            if req.sla_class == CLASS_BATCH \
            else (gov_active and self.queue.depth_of(CLASS_BATCH) == 0)
        if clamp_this and self.cfg.brownout_clamp > 0 \
                and req.max_new_tokens > self.cfg.brownout_clamp:
            # clamped BEFORE the journal sees the request: the WAL
            # records the budget actually served
            req.clamped_from = req.max_new_tokens
            req.max_new_tokens = self.cfg.brownout_clamp
        if self.journal is not None:
            # write-AHEAD of queue.submit: once queued, the engine thread
            # may emit the first token, whose record needs the admit
            # record on disk. A door rejection below closes it with a
            # terminal record, so it never replays.
            self.journal.admit(req)
            req._journaled = True
            self._journal_guard()
        ok, reason = self.queue.submit(req)
        if ok:
            self.metrics.on_accept(req.sla_class)
            if req.clamped_from is not None:
                self.metrics.on_clamp(req.sla_class)
            self.tracer.event("request_admitted", request=req.id,
                              prompt_len=req.prompt_len,
                              max_new_tokens=req.max_new_tokens,
                              deadline_s=req.deadline_s,
                              sla_class=req.sla_class,
                              **({"tenant": req.tenant}
                                 if req.tenant else {}),
                              **({"clamped_from": req.clamped_from}
                                 if req.clamped_from is not None else {}),
                              **_tr(req))
        else:
            req.finish_reason = "rejected"
            self.metrics.on_reject(reason)
            self.tracer.event("request_rejected", request=req.id,
                              reason=reason, prompt_len=req.prompt_len,
                              sla_class=req.sla_class, queued_s=0.0,
                              **_tr(req))
            self._emit(TokenEvent(req, None, True, kind="rejected",
                                  reason=reason))
        return ok, reason

    def reject_unparsed(self, rid: str | None, error: str) -> None:
        """Front-end hand-off for a line that never became a Request:
        counted and evented like a door reject."""
        self.metrics.on_reject(REJECT_BAD_REQUEST)
        self.tracer.event(
            "request_rejected",
            request=rid or f"unparsed_{next(self._unparsed)}",
            reason=REJECT_BAD_REQUEST, error=str(error)[:200],
            queued_s=0.0)

    # ------------------------------------------------- drain + recovery

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self, timeout_s: float = 30.0) -> None:
        """Flip to graceful drain (idempotent): the queue closes with
        `reject(reason="draining")`, in-flight slots and already-queued
        requests run to eos/budget, bounded by `timeout_s`."""
        if self._draining:
            return
        self._draining = True
        self._drain_deadline = _CLOCK() + max(0.0, timeout_s)
        self.queue.close(REJECT_DRAINING)
        self.tracer.event("serve_draining", tick=self._tick_no,
                          active=self.n_active, queue=len(self.queue),
                          timeout_s=timeout_s)

    def drain_expired(self) -> bool:
        return (self._draining and self._drain_deadline is not None
                and _CLOCK() > self._drain_deadline)

    def replay_pending(self, sink=None, *,
                       max_replays: int = MAX_REPLAYS_DEFAULT) -> dict:
        """Recover the journal into this engine — called once, after
        `warmup`, before the serve loop. Unfinished journaled requests
        re-enter the HEAD of the queue in admit order with their
        generated tokens riding along; the next pop re-prefills prompt +
        generated through the preemption recompute path, so the
        continuation is bit-identical (every draw is seeded by seed and
        position). Requests whose output was already complete owe the
        client only a terminal event; requests that crashed the engine
        `max_replays` times are quarantined (`request_poisoned`)."""
        if self.journal is None:
            return {"resumed": 0, "finished": 0, "poisoned": 0,
                    "clean": True}
        resume, finished, poisoned, clean = self.journal.recover(
            max_replays=max_replays, eos_id=self.cfg.eos_id)
        self._journal_guard()
        for req in finished:
            req.sink = sink
            req.status = "done"
            req.finish_reason = "recovered_complete"
            self.tracer.event(
                "request_finished", request=req.id, tick=self._tick_no,
                reason="recovered_complete", prompt_len=req.prompt_len,
                n_tokens=len(req.tokens), preempts=req.preempts,
                replayed=True, **_tr(req))
            self._emit(TokenEvent(req, None, True, kind="done",
                                  reason="recovered_complete"))
        for req in poisoned:
            req.sink = sink
            req.status = "rejected"
            req.finish_reason = REJECT_POISONED
            self.metrics.on_poisoned()
            self.tracer.event(
                "request_poisoned", request=req.id, replays=req.replays,
                prompt_len=req.prompt_len, generated=len(req.tokens),
                **_tr(req))
            self._emit(TokenEvent(req, None, True, kind="rejected",
                                  reason=REJECT_POISONED))
        for req in reversed(resume):  # reversed: first-admitted at head
            req.sink = sink
            req._journaled = True
            if req.tokens:
                # resumed mid-decode: its next queue wait banks as
                # replay, its prefill as replay_prefill, and no second
                # first-token event fires
                req._preempted = True
                req.first_token_at = req.submitted_at
            self.metrics.on_replay()
            self.tracer.event(
                "request_admitted", request=req.id,
                prompt_len=req.prompt_len,
                max_new_tokens=req.max_new_tokens,
                deadline_s=req.deadline_s, replayed=True,
                replay_n=req.replays, generated=len(req.tokens),
                **_tr(req))
            self.queue.push_front(req)
        if resume or finished or poisoned:
            self.tracer.event("journal_replayed", resumed=len(resume),
                              finished=len(finished),
                              poisoned=len(poisoned))
        return {"resumed": len(resume), "finished": len(finished),
                "poisoned": len(poisoned), "clean": clean}

    @property
    def n_active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and len(self.queue) == 0

    def _phase(self) -> str:
        if self._draining:
            return "drain"
        return "serve" if (self.n_active or len(self.queue)) \
            else "serve_idle"

    def _slo_tick(self) -> None:
        """Advance the SLO burn-rate state machines (rate-limited inside
        the monitor). Transitions emit alert_raised / alert_cleared and
        an unconditional heartbeat pulse carrying the active alerts."""
        if self.slo is None:
            return
        trs = self.slo.evaluate()
        if trs:
            slo_mod.publish(trs, self.tracer, self.metrics.reg,
                            step=self._tick_no, active=len(self.slo.active))
            self.hb.pulse(step=self._tick_no, phase=self._phase(),
                          active=self.n_active, queue=len(self.queue),
                          alerts=self.slo.active_names())

    def _beat_extra(self) -> dict:
        """The heartbeat's optional fields: active alerts, hot roots."""
        roots = self._hot_roots.top()
        return {**({"alerts": self.slo.active_names()}
                   if self.slo is not None else {}),
                **({"prefix_roots": roots} if roots else {})}

    # ------------------------------------------------ introspection

    def exposition(self, window_s: float = DEFAULT_WINDOW_S) -> dict:
        """Live snapshot for the exposition socket (obs/export.py):
        current loop state + lifetime metrics + the last-`window_s`
        windowed roll-up. Host floats and bounded ring copies only —
        answering never touches the device, whatever thread asks."""
        reg = self.metrics.reg
        gov = self._governor
        return {
            "role": "engine",
            "run": self.tracer.run,
            "phase": self._phase(),
            "tick": self._tick_no,
            "active": self.n_active,
            "slots": self.cfg.slots,
            "occupancy": round(self.n_active / self.cfg.slots, 4)
            if self.cfg.slots else 0.0,
            "queue": len(self.queue),
            "queue_by_class": self.queue.depth_by_class(),
            "draining": self._draining,
            "brownout": bool(gov.active) if gov is not None else False,
            # what degradation/scheduling posture this engine is in NOW
            "act": {
                "class_brownout": self._class_brownout,
                "brownout": bool(gov.active) if gov is not None else False,
                "chunking": len(self._chunking),
            },
            "blocks_in_use": self.mgr.in_use,
            "blocks_free": self.mgr.num_free,
            "alerts": (self.slo.active_names()
                       if self.slo is not None else []),
            "metrics": reg.snapshot(),
            "windows": reg.windowed_snapshot(window_s),
            "memory": self.memory_ledger(),
            "tickprof": self.tickprof.snapshot(window_s),
            "compile": {**self.ledger.last_seen,
                        "recompiles": self.ledger.recompiles},
        }

    def memory_ledger(self) -> dict:
        """Live memory accounting from known shapes — param bytes, the
        KV pool's full and in-use footprint, host RSS. Pure host
        arithmetic, so any thread may ask."""
        bb = self._block_bytes
        # device bytes the paged read copies per decode tick: the plain
        # version (the CPU path) gathers every slot's whole [MB] chain
        # into a contiguous view; the kernel reads the pools in place
        gather = 0 if self.device.type == "cuda" else \
            int(self.cfg.slots * self._mb * bb)
        return {
            "param_bytes": self._param_bytes,
            "kv_pool_bytes": int(self.cfg.num_blocks * bb),
            "blocks_in_use_bytes": int(self.mgr.in_use * bb),
            "kv_gather_bytes_per_tick": gather,
            "host_cache_mb": round(self.host.occupancy_mb, 3)
            if self.host is not None else 0.0,
            "host_cache_budget_mb": self.cfg.host_cache_mb,
            "rss_mb": hb_host_rss_mb(),
        }

    def _flight_payload(self) -> dict:
        """What a flight-record spill captures: loop state, the tick
        ring's tail, the windowed breakdown, compile counts, memory."""
        return {
            "phase": self._phase(),
            "active": self.n_active,
            "queue": len(self.queue),
            "ticks": self.tickprof.tail(32),
            "tickprof": self.tickprof.snapshot(),
            "compile": {**self.ledger.last_seen,
                        "recompiles": self.ledger.recompiles},
            "memory": self.memory_ledger(),
        }

    def flight_spill(self, reason: str, **extra) -> None:
        """Spill the flight record NOW — the server's SIGTERM handler,
        the fatal-exception path and the final drain call this.
        Host-only, so safe from a signal handler's frame."""
        if extra:
            self.flight.note(reason, **extra)
        self.flight.spill(reason, self._flight_payload(),
                          tick=self._tick_no)

    def control(self, req: dict) -> dict:
        """Control verbs arriving on the exposition socket (the
        request-line protocol in obs/export.py). `profile` brackets a
        `torch.profiler` trace on demand (utils/profiling.py);
        `class_brownout` sets the router-ordered batch brownout;
        anything unknown answers an error dict instead of raising — the
        exporter thread must never die of a bad request."""
        cmd = req.get("cmd")
        if cmd == "profile":
            from hyperion_tpu_torch.utils.profiling import on_demand_trace

            out = req.get("out")
            if not out:
                return {"status": "error", "error": "profile needs 'out'"}
            res = on_demand_trace(str(out),
                                  float(req.get("seconds") or 5.0),
                                  gate=self._tick_gate)
            self.tracer.event("profile_requested", **res)
            return res
        if cmd == "class_brownout":
            # shed/clamp the batch class as if the local governor were
            # active, never interactive: the order means "yield batch
            # capacity to the fleet". Idempotent.
            active = bool(req.get("active", True))
            changed = active != self._class_brownout
            self._class_brownout = active
            if changed:
                self.metrics.set_class_brownout(active)
                self.tracer.event("class_brownout", tick=self._tick_no,
                                  active=active, source="control")
            return {"status": "ok", "active": active, "changed": changed}
        return {"status": "error", "error": f"unknown cmd {cmd!r}"}

    def step(self) -> list[TokenEvent]:
        """One scheduling round (`_step`), under the tick gate."""
        with self._tick_gate:
            return self._step()

    def _step(self) -> list[TokenEvent]:
        """One scheduling round: brownout shedding, admit from the queue
        into free slots (block-gated, prefill, budget-limited), one
        chunked-prefill segment, ensure every live slot owns the blocks
        its next writes land in (preempting on exhaustion), advance all
        active slots — one token each, or 1..spec_k+1 under the
        speculative tick — and route emissions."""
        emissions: list[TokenEvent] = []
        now = _CLOCK()
        # host-tick profiler (obs/tickprof.py): stamp each segment of
        # this step into `seg`. Journal/sink time accumulates inside
        # _emit wherever it happens, so enclosing segments NET those
        # deltas out rather than double-charging them.
        seg: dict[str, float] = {}
        p_start = now
        j_start, s_start = self._journal_s, self._sink_s
        if self._governor is not None:
            tr = self._governor.update(len(self.queue))
            if tr == "enter":
                self.metrics.set_brownout(True)
                self.tracer.event(
                    "brownout_enter", tick=self._tick_no,
                    depth=len(self.queue),
                    wait_p95_ms=round(self._governor.wait_p95() * 1e3, 3))
            elif tr == "exit":
                self.metrics.set_brownout(False)
                self.tracer.event("brownout_exit", tick=self._tick_no,
                                  depth=len(self.queue))
        gov_active = self._governor is not None and self._governor.active
        if gov_active or self._class_brownout:
            # shed deadline-aware, BATCH FIRST: queued requests that
            # cannot meet their deadline even if service began after
            # their class's estimated wait are doomed — reject them now
            # so the client retries elsewhere. Interactive is swept only
            # when the local governor is active and batch is empty (a
            # router-ordered class brownout alone never touches it).
            shed_classes = [CLASS_BATCH]
            if gov_active and self.queue.depth_of(CLASS_BATCH) == 0:
                shed_classes = [CLASS_INTERACTIVE]
            est = {cls: self._governor.wait_p95(cls)
                   for cls in shed_classes} \
                if self._governor is not None else {}
            for req in self.queue.shed_doomed(
                    now, est_wait_by_class=est,
                    classes=tuple(shed_classes)):
                self.metrics.on_shed(req.sla_class)
                req.finish_reason = REJECT_SHED
                self.tracer.event(
                    "request_rejected", request=req.id,
                    tick=self._tick_no, reason=REJECT_SHED, shed=True,
                    sla_class=req.sla_class,
                    **({"tenant": req.tenant} if req.tenant else {}),
                    queued_s=round(max(0.0, now - req.enqueued_at), 6),
                    deadline_s=req.deadline_s)
                ev = TokenEvent(req, None, True, kind="rejected",
                                reason=REJECT_SHED)
                self._emit(ev)
                emissions.append(ev)

        t_seg = _CLOCK()
        free = [s for s, r in enumerate(self._slots) if r is None]
        if free:
            admit, expired = self.queue.pop_ready(
                len(free), now, can_admit=self._can_admit)
            # a block-gated head stops pop_ready's walk; a deadline
            # behind it must still fire on time
            expired += self.queue.drop_expired(now)
        else:
            admit, expired = [], self.queue.drop_expired(now)
        if CLASS_INTERACTIVE in self.queue.gate_blocked:
            # an interactive head denied by the block gate while batch
            # work holds slots: preempt the YOUNGEST batch slot (one per
            # step) so the freed blocks admit the head next round
            batch_live = [
                s for s, r in enumerate(self._slots)
                if r is not None and r.sla_class == CLASS_BATCH]
            if batch_live:
                victim = max(batch_live, key=lambda t: self._seqs[t].order)
                self._preempt(victim, reason="interactive_gate")
        seg["queue_pop"] = _CLOCK() - t_seg
        t_seg = _CLOCK()
        j_mark, s_mark = self._journal_s, self._sink_s
        for req in expired:
            self.metrics.on_timeout()
            req.finish_reason = "timed_out"
            self.tracer.event(
                "request_timeout", request=req.id,
                waited_s=round(now - req.submitted_at, 3),
                queued_s=round(max(0.0, now - req.enqueued_at), 6),
                **_tr(req))
            ev = TokenEvent(req, None, True, kind="timed_out",
                            reason="deadline exceeded in queue")
            self._emit(ev)
            emissions.append(ev)
        while admit:
            req = admit.pop(0)
            slot = free.pop(0)
            if self.chaos is not None:
                # poison_request@id=... fires as the request is about to
                # occupy a slot: the journal already holds its admit
                # record, so the replay counter sees every death it causes
                self.chaos.on_request(req.id)
            resumed = self._account_pop(req)
            ev = self._admit(req, slot)
            if ev is _CHUNK_ADMIT:
                continue  # prefilling in chunks: no token yet
            if ev is None:
                # allocation raced an eviction between gate and admit:
                # requeue head-first in arrival order, retry next round
                req._preempted = resumed
                for r in reversed([req] + admit):
                    if r.admitted_at is not None and r is not req:
                        r._preempted = self._account_pop(r)
                    self.tracer.event(
                        "request_requeued", request=r.id,
                        tick=self._tick_no, reason="alloc_race")
                    self.mgr.release(self._pending_reserve.pop(r.id, 0))
                    self.queue.push_front(r)
                break
            self._emit(ev)
            emissions.append(ev)
            if ev.finished:
                self._on_finished(req)
        # admit covers expiry + admission + their prefill calls, net of
        # the journal/sink writes those paths perform
        seg["admit"] = max(0.0, (_CLOCK() - t_seg)
                           - (self._journal_s - j_mark)
                           - (self._sink_s - s_mark))
        # one chunked-prefill segment per step, between decode ticks
        t_seg = _CLOCK()
        j_mark, s_mark = self._journal_s, self._sink_s
        for ev in self._advance_chunks():
            self._emit(ev)
            emissions.append(ev)
            if ev.finished:
                self._on_finished(ev.request)
        seg["chunk"] = max(0.0, (_CLOCK() - t_seg)
                           - (self._journal_s - j_mark)
                           - (self._sink_s - s_mark))

        if self.n_active:
            self._ensure_blocks()
        if self.n_active - len(self._chunking) > 0:
            if self.chaos is not None:
                self.chaos.on_tick(self._tick_no)
            spec = self._spec
            t_seg = _CLOCK()
            drafts = self._collect_drafts() if spec else None
            seg["draft"] = _CLOCK() - t_seg
            u_mark = self.tier.upload_s
            with self.tracer.span("serve_tick", step=self._tick_no) as sp:
                t0 = _CLOCK()
                if spec:
                    toks, cnts, accs, fins = self._spec_tick_device(drafts)
                else:
                    toks, fins = self._tick_device()
                dur = _CLOCK() - t0
                sp.set(active=self.n_active)
            # the device call's wall splits into the host->device copy of
            # the tick's inputs (tables, depths, tokens) and dispatch+wait
            seg["bt_upload"] = self.tier.upload_s - u_mark
            seg["device"] = max(0.0, dur - seg["bt_upload"])
            emitted = 0
            slot_ticks = 0
            tnow = _CLOCK()
            j_mark, s_mark = self._journal_s, self._sink_s
            for s, req in enumerate(self._slots):
                if req is None or s in self._chunking:
                    continue  # a chunking lane computed pad into null
                slot_ticks += 1
                n = int(cnts[s]) if spec else 1
                if spec:
                    self.metrics.on_spec(self.cfg.spec_k, int(accs[s]))
                if n == 0:
                    continue
                self._seqs[s].n_filled += n
                gap_from = getattr(req, "_last_emit_at", None)
                if gap_from is not None:
                    # net the gap of ALL sink writes since this request's
                    # previous emission: a slow neighbour's client must
                    # not masquerade as decode time. One verify pass
                    # produced n tokens, so TPOT charges it pro rata.
                    for _ in range(n):
                        self.metrics.on_token_gap((tnow - gap_from) / n,
                                                  req.sla_class)
                    sink = self._sink_s - getattr(req, "_sink_mark",
                                                  self._sink_s)
                    req.decode_s += max(0.0, tnow - gap_from - sink)
                req._last_emit_at = tnow
                req._sink_mark = self._sink_s
                fin = bool(fins[s])
                # every accepted token takes the per-token path of the
                # sequential tick: one journal record, one stream index,
                # one sink write apiece
                for j in range(n):
                    tok = int(toks[s, j]) if spec else int(toks[s])
                    ev = TokenEvent(req, tok, fin and j == n - 1)
                    self._emit(ev)
                    emissions.append(ev)
                    emitted += 1
                if fin:
                    self._on_finished(req)
                    self._free_slot(s)
            # accept host path: token routing + gap netting, minus the
            # journal/sink writes _emit charged to their own segments
            seg["accept"] = max(0.0, (_CLOCK() - tnow)
                                - (self._journal_s - j_mark)
                                - (self._sink_s - s_mark))
            self.metrics.on_tick(dur, emitted, slot_ticks)
            self._tick_no += 1
            if self.cfg.snapshot_every \
                    and self._tick_no % self.cfg.snapshot_every == 0:
                rss = hb_host_rss_mb()
                if rss is not None:
                    # a gauge SERIES across snapshots: doctor reads the
                    # trend for its host-leak warning
                    self.metrics.reg.gauge("host_rss_mb").set(rss)
                self.tracer.snapshot(self.metrics.reg, step=self._tick_no,
                                     tickprof=self.tickprof.snapshot())

        # compile ledger: any growth after warmup is a broken invariant
        # (a shape nobody warmed captured a new graph) — count it, name
        # the surface, and leave churn context for doctor
        growth = self.ledger.check(self.compile_stats())
        if growth:
            self.metrics.on_recompile(
                sum(g["after"] - g["before"] for g in growth))
            for g in growth:
                ctx = dict(tick=self._tick_no, active=self.n_active,
                           queue=len(self.queue),
                           last_prefill_bucket=self._last_prefill_bucket)
                self.tracer.event("recompile_after_warmup",
                                  executable=g["executable"],
                                  before=g["before"], after=g["after"],
                                  **ctx)
                self.flight.note("recompile_after_warmup",
                                 executable=g["executable"], **ctx)

        seg["journal"] = self._journal_s - j_start
        seg["sink"] = self._sink_s - s_start
        t_seg = _CLOCK()
        self.metrics.observe_state(
            len(self.queue), self.n_active, self.cfg.slots)
        self.metrics.observe_cache(
            self.mgr.in_use, self.mgr.num_free, self.n_active,
            self._block_bytes)
        self._slo_tick()
        self.hb.beat(step=self._tick_no, phase="serve",
                     active=self.n_active, queue=len(self.queue),
                     **self._beat_extra())
        seg["slo"] = _CLOCK() - t_seg
        self.tickprof.record(self._tick_no, seg, _CLOCK() - p_start)
        if self.flight.due(self._tick_no):
            self.flight.spill("periodic", self._flight_payload(),
                              tick=self._tick_no)
        return emissions

    def run(
        self,
        *,
        should_stop: Callable[[], bool] | None = None,
        drain_when: Callable[[], bool] | None = None,
        idle_sleep_s: float = 0.01,
    ) -> dict:
        """Serve until `should_stop()` (hard stop) or until
        `drain_when()` and the engine is idle (graceful drain; default:
        drain immediately once idle). Emits `serve_start`/`serve_end`
        lifecycle events."""
        drain_when = drain_when or (lambda: True)
        self.tracer.event(
            "serve_start", slots=self.cfg.slots, max_len=self.cfg.max_len,
            block_size=self.cfg.block_size, num_blocks=self.cfg.num_blocks,
            prefix_cache=self.cfg.prefix_cache,
            host_cache_mb=self.cfg.host_cache_mb, device=str(self.device))
        self.hb.pulse(phase="serve", step=self._tick_no)
        try:
            while True:
                if should_stop is not None and should_stop():
                    break
                if self.drain_expired():
                    self.tracer.event("drain_timeout", tick=self._tick_no,
                                      active=self.n_active,
                                      queue=len(self.queue))
                    break
                if self.idle:
                    # drain_when first, idle RE-checked after: a
                    # transport's last submit happens-before its EOF flag
                    if (self._draining or drain_when()) and self.idle:
                        break
                    # an alert raised under load must be able to clear
                    # while the loop sits idle: the idle loop owns the
                    # evaluation cadence here
                    self._slo_tick()
                    self.hb.beat(step=self._tick_no, phase="serve_idle",
                                 active=0, queue=len(self.queue),
                                 **self._beat_extra())
                    time.sleep(idle_sleep_s)
                    continue
                self.step()
        except BaseException as e:
            # the flight record IS the post-mortem: spill before the
            # exception unwinds, so doctor can cite the final ticks
            self.flight_spill("fatal_exception", error=repr(e)[:200])
            raise
        finally:
            summary = self.metrics.summary()
            self.tracer.snapshot(self.metrics.reg, step=self._tick_no)
            self.tracer.event(
                "serve_end", ticks=self._tick_no,
                completed=summary["completed"],
                rejected=summary["rejected"],
                timed_out=summary["timed_out"],
                tokens=summary["tokens"],
                prefix_hits=summary["prefix_hits"],
                preempted=summary["preempted"],
                alerts_raised=summary["alerts_raised"],
                tier_hits_host=summary["tier_hits_host"],
                tier_hits_device=summary["tier_hits_device"],
                tier_miss=summary["tier_miss"],
                host_spilled_blocks=summary["host_spilled_blocks"],
                host_restored_blocks=summary["host_restored_blocks"])
            if self.host is not None and self.cfg.host_cache_dir:
                try:
                    st = self.host.save(self.cfg.host_cache_dir)
                    self.tracer.event(
                        "hostcache_saved", chains=st["chains"],
                        mb=st["mb"], path=self.cfg.host_cache_dir)
                except OSError as e:
                    # persistence is an optimization, never a crash on
                    # the drain path: say so and finish the drain
                    print(f"[serve] host-cache save failed: {e}",
                          file=sys.stderr)
            self.flight_spill("serve_end")
            self.hb.close(phase="done", tokens=summary["tokens"],
                          active=self.n_active, queue=len(self.queue))
        return summary
