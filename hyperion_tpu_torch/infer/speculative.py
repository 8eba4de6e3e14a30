"""Speculative decoding — `hyperion_tpu/infer/speculative.py` in PyTorch.

A small draft model proposes `k` tokens greedily, then the target model
scores all of them in ONE forward over a `k+1` window. The acceptance
rule keeps the longest proposal prefix the target agrees with, plus the
target's own next token, so each round emits 1..k+1 tokens for one
target forward and the output is token for token the target's own
greedy decode (`infer.generate.generate` at temperature 0).

KV caches are never rolled back: both models mask attention by
position, so entries past the accepted index are invisible and later
rounds overwrite them. The draft re-feeds a fixed `k+1` window each
round, which rewrites the one entry a fully accepted round left
unwritten (recomputing an existing entry writes the same K/V).

Scope: greedy, where the equality is exact. Prompts must be longer
than `k` (the re-feed window reaches k positions back). Batch rows
decode one after another through the single-row routine, as the
reference's `vmap` runs each row independently. `accept_draft` is the
rule the serve engine's speculative tick applies per slot over its
`[S, k+1]` verify window.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from hyperion_tpu_torch import resolve_device


def accept_draft(draft: torch.Tensor, target: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The acceptance rule: the longest draft prefix agreeing with the
    target, plus the target's own token at the first disagreement (or
    its bonus token after full acceptance).

    `draft` [..., k] are the proposals for the next k positions;
    `target` [..., k+1] the tokens the target itself would emit at those
    k+1 positions. Leading dims are batch dims. Returns `(m, v)`: `m`
    [...] int32 counts the accepted proposals (0..k), `v` [..., k+1] (in
    draft's dtype) holds the decided tokens — positions <= m are what
    sequential decoding with the target alone produces; positions above
    m are junk a caller must never emit."""
    k = draft.shape[-1]
    if k < 1 or target.shape[-1] != k + 1:
        raise ValueError(f"need draft [..., k>=1] and target [..., k+1], "
                         f"got {tuple(draft.shape)} and "
                         f"{tuple(target.shape)}")
    target = target.to(draft.dtype)
    matches = draft == target[..., :k]
    first_miss = (~matches).to(torch.int32).argmax(dim=-1)
    m = torch.where(matches.all(dim=-1), torch.full_like(first_miss, k),
                    first_miss).to(torch.int32)
    ext = torch.cat([draft, torch.zeros_like(draft[..., :1])], dim=-1)
    at_m = torch.arange(k + 1, device=draft.device) == m[..., None]
    return m, torch.where(at_m, target, ext)


@torch.no_grad()
def generate_speculative(
    model: Any,
    draft_model: Any,
    prompt_ids,
    max_new_tokens: int,
    *,
    k: int = 4,
    eos_id: int | None = None,
    pad_id: int = 0,
    device=None,
) -> torch.Tensor:
    """Greedy speculative decode → ids [B, max_new_tokens] (int64, on the
    models' device), row for row `generate(model, ...)` at temperature 0.

    Both models must share a vocabulary and take the contiguous-cache
    call (`init_cache`). Each round costs one draft pass over the
    `k+1` window, k-1 single draft steps and ONE target pass over k+1
    tokens. `device` (None = cuda:0) must be where both models live."""
    from hyperion_tpu_torch.models.llama import init_cache

    dev = resolve_device(device)
    for name, m in (("model", model), ("draft_model", draft_model)):
        if m.device != dev:
            raise ValueError(f"{name} is on {m.device}, device is {dev}")
    ids = torch.as_tensor(np.asarray(prompt_ids), device=dev).long()
    B, P = ids.shape
    if B < 1:
        raise ValueError(f"need at least one row (got batch {B})")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if P <= k:
        raise ValueError(
            f"prompt length {P} must exceed k={k} (the draft re-feed "
            "window reaches k positions back)")
    cfg_t, cfg_d = model.cfg, draft_model.cfg
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError(f"vocab mismatch: target {cfg_t.vocab_size} vs "
                         f"draft {cfg_d.vocab_size}")
    # the sequence buffer holds prompt + generated + one round's overshoot
    L = P + max_new_tokens + k + 1
    if L > min(cfg_t.max_len, cfg_d.max_len):
        raise ValueError(
            f"prompt {P} + {max_new_tokens} new tokens (+{k + 1} "
            f"speculation slack) exceeds max_len "
            f"{min(cfg_t.max_len, cfg_d.max_len)}")

    def row(prompt: torch.Tensor) -> torch.Tensor:
        t_cache = init_cache(cfg_t, 1, max_len=L, device=dev)
        d_cache = init_cache(cfg_d, 1, max_len=L, device=dev)
        # prefill both; the first token is the target's, as in generate
        t_logits, _ = model(prompt[None], cache=t_cache, cache_index=0)
        draft_model(prompt[None], cache=d_cache, cache_index=0)
        seq = torch.zeros(L, dtype=torch.long, device=dev)
        seq[:P] = prompt
        seq[P] = torch.argmax(t_logits[0, -1])
        idx, n_gen = P, 1
        while n_gen < max_new_tokens:
            # draft: re-feed the (k+1)-window ending at idx, then k-1
            # single steps; proposal i is for position idx+1+i
            d_logits, _ = draft_model(seq[idx - k:idx + 1][None],
                                      cache=d_cache, cache_index=idx - k)
            props = [torch.argmax(d_logits[0, -1])]
            for i in range(k - 1):
                d_logits, _ = draft_model(props[-1].view(1, 1),
                                          cache=d_cache,
                                          cache_index=idx + 1 + i)
                props.append(torch.argmax(d_logits[0, 0]))
            d_arr = torch.stack(props)
            # target: one pass over [tok, d_1..d_k]; row i predicts
            # position idx+1+i
            t_logits, _ = model(torch.cat([seq[idx:idx + 1], d_arr])[None],
                                cache=t_cache, cache_index=idx)
            m, v = accept_draft(d_arr, torch.argmax(t_logits[0], dim=-1))
            # v above m is junk that later rounds overwrite before any
            # read; m is the round's one host read
            seq[idx + 1:idx + k + 2] = v
            step = int(m) + 1
            idx += step
            n_gen += step
        return seq[P:P + max_new_tokens]

    out = torch.stack([row(ids[b]) for b in range(B)])
    if eos_id is not None:
        # generate's contract: positions after the first eos become pad
        is_eos = (out == eos_id).long()
        after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        out = torch.where(after, torch.full_like(out, pad_id), out)
    return out
