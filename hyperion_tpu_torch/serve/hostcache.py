"""Tiered KV cache — the host-RAM spill tier behind the radix cache, a
copy of `hyperion_tpu/serve/hostcache.py` (numpy and the stdlib only).

The radix prefix cache (`serve/blocks.py`) turns a shared prompt into
shared device blocks, but its eviction is terminal: under pool pressure
a cold chain is dropped and a later same-prefix request pays the full
re-prefill. Host RAM is ~10x the card's memory and one copy away, so
eviction DEMOTES instead:

  * `HostBlockStore` — evicted full-block prefix chains as host numpy
    buffers under an LRU `host_cache_mb` budget. Each entry is keyed by
    the chain's full token prefix (root..block inclusive), so a later
    lookup extends a device match by walking consecutive keys:
    device-hit for the first k blocks, host-hit for the next m, miss
    for the rest.
  * `save`/`load` — the store serializes to a directory on drain
    (index.json + one raw chains.bin, written atomically), so a spilled
    chain outlives the process.
  * `prefix_root_digest` + `HotRootTracker` — the digests of the prompt
    roots an engine served, which it advertises on its heartbeat.

What differs from the reference: payloads are the pool's RAW BITS, an
integer array of the pool dtype's width (a bf16 pool's block is int16),
and the store records the pool dtype by name (`dtype`). numpy has no
bfloat16, so this keeps a bf16 store bit-exact through `save`/`load`
without any extension module; the engine views the bits back as the
pool's dtype on restore. A store saved for another pool dtype or block
size loads nothing.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict

import numpy as np

# Tokens hashed into a prefix-root digest (the reference router's
# affinity `prefix_tokens` default).
PREFIX_ROOT_TOKENS = 32

# Roots a replica advertises per heartbeat.
TOP_ROOTS = 8

# Tier report keys the serving row promises to `obs diff`: the
# scripts/check_diff_gates_torch.py guard fails tier-1 when any is
# missing from the diff gate table (a promised but ungated key is a
# metric nobody would see regress).
TIER_GATED = (
    "serve_tier_hit_rate_host",
    "serve_restore_bytes_per_s",
    "serve_prefill_tokens_saved",
)

INDEX_NAME = "index.json"
CHAINS_NAME = "chains.bin"


def prefix_root_digest(token_ids, n: int = PREFIX_ROOT_TOKENS) -> str | None:
    """Stable digest of a prompt's first `n` token ids (comma-joined
    ints, sha1, 16 hex chars); None for an empty prompt."""
    ids = [int(t) for t in list(token_ids)[:n]]
    if not ids:
        return None
    return hashlib.sha1(
        ",".join(str(t) for t in ids).encode()).hexdigest()[:16]


class HotRootTracker:
    """Recency-ordered, bounded set of prefix-root digests this engine
    served; `top()` returns most-recent-first."""

    def __init__(self, cap: int = 64):
        self.cap = cap
        self._roots: OrderedDict[str, None] = OrderedDict()

    def note(self, digest: str | None) -> None:
        if not digest:
            return
        self._roots.pop(digest, None)
        self._roots[digest] = None
        while len(self._roots) > self.cap:
            self._roots.popitem(last=False)

    def top(self, k: int = TOP_ROOTS) -> list[str]:
        return list(self._roots)[-k:][::-1]

    def __len__(self) -> int:
        return len(self._roots)


class HostBlockStore:
    """Evicted prefix chains in host RAM under an LRU byte budget.

    Keys are the chain's FULL token prefix, so consecutive chain links
    are independent entries: `match` extends a device hit of k full
    blocks by probing `tokens[:k*bs+bs]`, `tokens[:k*bs+2*bs]`, ..., and
    a mid-chain LRU eviction shortens what a given device base can
    restore. Payloads are `[n_layers, 2(k/v), block_size, n_kv_heads,
    head_dim]` raw-bit arrays of the `dtype` pool. Content under a key
    is immutable (full blocks are never written again), so a re-spill
    of a held key only refreshes its recency."""

    def __init__(self, budget_mb: int, block_size: int,
                 dtype: str = "float32"):
        if budget_mb <= 0:
            raise ValueError(f"host cache budget must be > 0 MB, "
                             f"got {budget_mb}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.budget_bytes = int(budget_mb) * 2 ** 20
        self.block_size = block_size
        self.dtype = dtype
        self._chains: OrderedDict[tuple[int, ...], np.ndarray] = \
            OrderedDict()
        self.bytes_used = 0
        self.spills = 0          # chains accepted by put()
        self.restores = 0        # blocks handed back by match()
        self.evictions = 0       # chains LRU-dropped for budget
        self.rejected = 0        # puts refused (payload alone > budget)

    # ------------------------------------------------------------ reads

    def __len__(self) -> int:
        return len(self._chains)

    @property
    def occupancy_mb(self) -> float:
        return self.bytes_used / 2 ** 20

    def match(self, tokens, start: int, limit: int) -> list[np.ndarray]:
        """Consecutive spilled blocks extending a device match: `start`
        is the device full-block coverage in tokens (a multiple of
        block_size), `limit` caps matched positions (callers pass len-1:
        one token must remain to prefill). Returns the payloads in chain
        order; every hit refreshes LRU recency."""
        bs = self.block_size
        toks = [int(t) for t in list(tokens)[:limit]]
        out: list[np.ndarray] = []
        pos = start
        while pos + bs <= limit:
            key = tuple(toks[:pos + bs])
            payload = self._chains.get(key)
            if payload is None:
                break
            self._chains.move_to_end(key)
            out.append(payload)
            pos += bs
        self.restores += len(out)
        return out

    def stats(self) -> dict:
        return {
            "chains": len(self._chains),
            "bytes": self.bytes_used,
            "mb": round(self.occupancy_mb, 3),
            "spills": self.spills,
            "restores": self.restores,
            "evictions": self.evictions,
            "rejected": self.rejected,
        }

    # ----------------------------------------------------------- writes

    def put(self, chain_tokens, payload: np.ndarray) -> bool:
        """Accept one evicted block: `chain_tokens` is the FULL prefix
        (length a multiple of block_size, the last block_size ids this
        block's own), `payload` its raw K/V bits. Returns False when the
        payload alone exceeds the whole budget (counted, never raised:
        spilling is opportunistic)."""
        key = tuple(int(t) for t in list(chain_tokens))
        if not key or len(key) % self.block_size != 0:
            raise ValueError(
                f"chain key length {len(key)} is not a multiple of "
                f"block_size {self.block_size}")
        if key in self._chains:
            self._chains.move_to_end(key)
            return True
        payload = np.asarray(payload)
        if payload.nbytes > self.budget_bytes:
            self.rejected += 1
            return False
        self._chains[key] = payload
        self.bytes_used += payload.nbytes
        self.spills += 1
        while self.bytes_used > self.budget_bytes:
            _, old = self._chains.popitem(last=False)
            self.bytes_used -= old.nbytes
            self.evictions += 1
        return True

    def clear(self) -> None:
        self._chains.clear()
        self.bytes_used = 0

    # ------------------------------------------------------ persistence

    def save(self, dirpath: str) -> dict:
        """Serialize to `dirpath` (index.json + chains.bin, both written
        to temp names then renamed: a crash mid-save leaves the previous
        snapshot intact), oldest chain first so `load` rebuilds the LRU
        order. Returns the stats of what was written."""
        os.makedirs(dirpath, exist_ok=True)
        index: list[dict] = []
        offset = 0
        bin_tmp = os.path.join(dirpath, CHAINS_NAME + ".tmp")
        with open(bin_tmp, "wb") as f:
            for key, payload in self._chains.items():
                raw = payload.tobytes()
                f.write(raw)
                index.append({
                    "tokens": list(key),
                    "shape": list(payload.shape),
                    "bits": payload.dtype.name,
                    "offset": offset,
                    "nbytes": len(raw),
                })
                offset += len(raw)
        idx_tmp = os.path.join(dirpath, INDEX_NAME + ".tmp")
        with open(idx_tmp, "w") as f:
            json.dump({"v": 1, "block_size": self.block_size,
                       "dtype": self.dtype, "chains": index}, f)
        os.replace(bin_tmp, os.path.join(dirpath, CHAINS_NAME))
        os.replace(idx_tmp, os.path.join(dirpath, INDEX_NAME))
        return self.stats()

    def load(self, dirpath: str) -> int:
        """Rebuild from a prior `save` (missing or corrupt files, or
        another pool geometry or dtype, load nothing: persistence is an
        optimization, never a crash). Entries load oldest-first through
        the LRU budget, so a smaller budget keeps the most recent
        chains. Returns chains loaded."""
        try:
            with open(os.path.join(dirpath, INDEX_NAME)) as f:
                index = json.load(f)
            with open(os.path.join(dirpath, CHAINS_NAME), "rb") as f:
                raw = f.read()
        except (OSError, ValueError):
            return 0
        if index.get("block_size") != self.block_size \
                or index.get("dtype") != self.dtype:
            return 0  # another pool's chains
        loaded = 0
        for ent in index.get("chains", []):
            try:
                bits = np.dtype(ent["bits"])
                off, nb = int(ent["offset"]), int(ent["nbytes"])
            except (KeyError, TypeError, ValueError):
                continue
            if off + nb > len(raw):
                continue
            payload = np.frombuffer(
                raw[off:off + nb], dtype=bits).reshape(ent["shape"])
            if self.put(ent["tokens"], payload.copy()):
                loaded += 1
        return loaded


def ungated_tier_keys(diff_metrics: dict) -> list[str]:
    """Tier keys promised by `TIER_GATED` but absent from the obs diff
    gate table: scripts/check_diff_gates_torch.py fails tier-1 on any."""
    return sorted(k for k in TIER_GATED if k not in diff_metrics)
