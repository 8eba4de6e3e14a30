"""Draft sources for the engine's speculative tick — self-drafting
n-gram lookup, behind an interface a real draft model can implement.
A copy of `hyperion_tpu/serve/draft.py` (numpy only).

The serve engine (`serve/engine.py`) drafts up to k tokens per active
slot each tick and verifies them all in ONE batched target forward.
What proposes those tokens is pluggable: `DraftSource.propose` maps a
slot's visible context (prompt + everything generated so far) to k
candidate next tokens. Correctness never depends on the proposals —
the verify pass accepts exactly the longest prefix the target itself
would have produced (`infer/speculative.accept_draft`), so a bad draft
costs speed, never tokens. That makes the interface safe to fill with
anything cheap.

`NgramDraft` is the no-second-checkpoint baseline (prompt-lookup /
suffix-matching decoding): find the most recent earlier occurrence of
the current context suffix and propose the tokens that followed it.
Pure host-side numpy over the per-slot token lists the engine already
keeps — the `[S, k]` proposal array ships with the tick like the block
table, so drafting adds zero device work.
It wins exactly when decoding revisits its own context — system-prompt
boilerplate, quoted input, code idioms, and the repetitive spans
(lists, loops) where sequential decoding wastes the most ticks.

A future tiny-model drafter implements the same `propose` (keyed by
`slot` so it can keep per-slot state across ticks) and plugs in behind
`--draft` without touching the engine.
"""

from __future__ import annotations

import numpy as np


class DraftSource:
    """Interface the engine calls once per active slot per tick.

    `propose(slot, prompt_ids, generated, k)` returns k int32 token
    proposals for the slot whose visible context is `prompt_ids`
    (np.ndarray) followed by `generated` (host list of emitted token
    ints). Proposals are verified — never trusted — so any return
    value is safe; garbage just decays the tick to one token. `slot`
    identifies the lane so stateful drafters can cache per-slot work
    (the engine reuses slot indices after a request frees, so keying
    on slot alone is only valid within one request's residency —
    derive identity from the context if state must outlive it).
    """

    def propose(self, slot: int, prompt_ids: np.ndarray,
                generated: list[int], k: int) -> np.ndarray:
        raise NotImplementedError


class NgramDraft(DraftSource):
    """Self-drafting suffix lookup: propose the continuation of the
    most recent earlier occurrence of the context's current suffix,
    longest suffix (up to `max_ngram` tokens) first."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, slot: int, prompt_ids: np.ndarray,
                generated: list[int], k: int) -> np.ndarray:
        ctx = np.asarray(prompt_ids, np.int32)
        if generated:
            ctx = np.concatenate(
                [ctx, np.asarray(generated, np.int32)])
        n_ctx = int(ctx.shape[0])
        # fallback proposal: repeat the last token — free to verify,
        # and exactly right whenever decoding has entered a 1-cycle
        out = np.full((k,), int(ctx[-1]) if n_ctx else 0, np.int32)
        for n in range(min(self.max_ngram, n_ctx - 1), 0, -1):
            pat = ctx[n_ctx - n:]
            wins = np.lib.stride_tricks.sliding_window_view(ctx, n)
            # candidate starts, excluding the suffix matching itself
            hits = np.flatnonzero((wins[:-1] == pat).all(axis=1))
            if hits.size == 0:
                continue
            src = int(hits[-1]) + n  # most recent occurrence wins
            cont = ctx[src:src + k]
            out[:cont.shape[0]] = cont
            break
        return out
