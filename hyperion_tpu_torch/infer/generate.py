"""Sampling and KV-cache generation — `hyperion_tpu/infer/generate.py`
in PyTorch (`:45-195`, `:263-346`).

`generate` decodes one batch of aligned prompts: a prefill writes the
prompt's K/V into a contiguous cache sized to prompt + new tokens, then
one forward per new token. At temperature 0 it is argmax all the way,
and it is the serve engine's oracle: an engine stream at temperature 0
equals `generate` on the same prompt, token for token.

Random draws. Torch cannot reproduce JAX's threefry bits, so the port
has its own contract, tested by distribution rather than against JAX:

  * `generate` draws every step from the caller's `torch.Generator`;
  * the serve engine's per-slot draws (`sample_token_slots`) use, for
    the token at position `p` of a request seeded `seed`, a fresh
    generator seeded with `draw_seed(seed, p)` — so a request yields
    the same stream whatever else shares its batch;
  * rows at temperature 0 never draw.

A draw is Gumbel-max over the restricted logits: argmax(logits / T +
Gumbel noise), which samples exactly softmax(logits / T) over the
support that top-k and top-p leave.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from hyperion_tpu_torch import resolve_device

_U64 = (1 << 64) - 1


def _mask_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Batch-uniform top-k: below the k-th largest logit per row → -inf."""
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _mask_top_k_rows(scaled: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k (0 = off): the threshold is the clip(k-1)-th value
    of the row sorted descending, from a full sort, as the reference's
    `sample_token_slots` takes it."""
    V = scaled.shape[-1]
    k = top_k.clamp(0, V)
    sorted_desc = -torch.sort(-scaled, dim=-1, stable=True).values
    kth = torch.gather(sorted_desc, -1, (k - 1).clamp(0, V - 1)[:, None])
    return scaled.masked_fill((k > 0)[:, None] & (scaled < kth),
                              float("-inf"))


def _mask_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus restriction: keep the smallest prefix of the sorted
    distribution whose mass reaches top_p (the first token always
    survives). `top_p` is a float or a [B, 1] tensor; p = 1.0 rows are
    an exact no-op."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(mass_before < top_p, sorted_logits,
                       torch.full_like(sorted_logits, float("-inf")))
    return torch.full_like(logits, float("-inf")).scatter(-1, order, kept)


def draw_seed(seed: int, position: int) -> int:
    """splitmix64 of (seed, position): the generator seed for the draw
    of a request's token at `position`."""
    z = ((int(seed) & _U64) ^ ((int(position) * 0x9E3779B97F4A7C15) & _U64))
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def _gumbel_argmax(restricted: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of `restricted` [B, V] (-inf =
    excluded) by Gumbel-max."""
    u = torch.rand(restricted.shape, generator=generator,
                   device=restricted.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(restricted.float() + gumbel, dim=-1)


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """logits [B, V] → token ids [B] (int64). temperature 0 = greedy;
    top_k then top_p restrict the support after the rescale."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 sampling needs a torch.Generator")
    logits = logits / temperature
    if top_k > 0:
        logits = _mask_top_k(logits, top_k)
    if top_p < 1.0:
        if top_p <= 0.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        logits = _mask_top_p(logits, top_p)
    return _gumbel_argmax(logits, generator)


def restrict_slots(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row rescale + top-k + top-p of the reference's
    `sample_token_slots` (`generate.py:103-117`): the support each row
    draws from. temperature <= 0 rows are left unscaled (they never
    draw)."""
    t = temperature.to(logits.dtype)
    scaled = logits / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    restricted = _mask_top_k_rows(scaled, top_k)
    return _mask_top_p(restricted, top_p.to(logits.dtype)[:, None])


def sample_token_slots(logits: torch.Tensor, temperature, top_k, top_p,
                       seeds, positions) -> torch.Tensor:
    """Per-row sampling for the serve engine: logits [S, V] with per-slot
    host params (each length S) → token ids [S] on logits' device.
    Rows with temperature <= 0 take the argmax and draw nothing; the
    others draw with a generator seeded by `draw_seed(seed, position)`."""
    greedy = torch.argmax(logits, dim=-1)
    temperature = np.asarray(temperature, np.float32)
    hot = np.flatnonzero(temperature > 0)
    if hot.size == 0:
        return greedy
    dev = logits.device
    idx = torch.as_tensor(hot, device=dev)
    restricted = restrict_slots(
        logits[idx],
        torch.as_tensor(temperature[hot], device=dev),
        torch.as_tensor(np.asarray(top_k, np.int64)[hot], device=dev),
        torch.as_tensor(np.asarray(top_p, np.float32)[hot], device=dev))
    out = greedy.clone()
    for j, s in enumerate(hot.tolist()):
        g = torch.Generator(device=dev)
        g.manual_seed(draw_seed(int(seeds[s]), int(positions[s])))
        out[s] = _gumbel_argmax(restricted[j:j + 1], g)[0]
    return out


@torch.no_grad()
def generate(
    model: Any,
    prompt_ids,
    max_new_tokens: int,
    *,
    eos_id: int | None = None,
    pad_id: int = 0,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,
    device=None,
) -> torch.Tensor:
    """KV-cache decoding → generated ids [B, max_new_tokens] (int64, on
    the model's device). `prompt_ids` [B, P] must be dense; P +
    max_new_tokens must fit the model's max_len. `device` (None =
    cuda:0) must be where the model lives."""
    from hyperion_tpu_torch.models.llama import init_cache

    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, device is {dev}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 sampling needs a torch.Generator")
    ids = torch.as_tensor(np.asarray(prompt_ids), device=dev).long()
    B, P = ids.shape
    cfg = model.cfg
    if P + max_new_tokens > cfg.max_len:
        raise ValueError(f"prompt {P} + {max_new_tokens} new tokens exceeds "
                         f"max_len {cfg.max_len}")
    # sized to the tokens actually produced, as the reference does
    cache = init_cache(cfg, B, max_len=P + max_new_tokens, device=dev)
    logits, cache = model(ids, cache=cache, cache_index=0)
    tok = sample_token(logits[:, -1], generator, temperature, top_k, top_p)
    done = torch.zeros(B, dtype=torch.bool, device=dev) if eos_id is None \
        else tok == eos_id
    out = [tok]
    for i in range(1, max_new_tokens):
        logits, cache = model(tok[:, None], cache=cache, cache_index=P + i - 1)
        nxt = sample_token(logits[:, 0], generator, temperature, top_k, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def model_from_npz(params: dict, max_len: int = 4096, *,
                   dtype: str = "bfloat16", device=None):
    """Rebuild a Llama whose shape matches a gathered export and load
    its weights. max_len is not recoverable from the weights (RoPE has
    no table), so it is an argument; `dtype` is the compute dtype (the
    reference's loader gives bfloat16). Other layouts raise."""
    from hyperion_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        params_from_jax,
    )

    if "embed_tokens" not in params:
        kind = ("pipeline" if "stages" in params
                else "TransformerLM/MoE" if "tok_emb" in params
                else "unrecognized")
        raise ValueError(
            f"{kind} checkpoint (top-level keys {sorted(params)[:6]}): the "
            "port loads Llama exports only; the other models come with "
            "the training slice (ROADMAP A7)")
    vocab, d_model = params["embed_tokens"]["embedding"].shape
    n_layers = len([k for k in params if k.startswith("layer_")])
    l0 = params["layer_0"]
    _, n_heads, _ = l0["attn"]["q_proj"]["kernel"].shape
    _, n_kv_heads, _ = l0["attn"]["k_proj"]["kernel"].shape
    ff_dim = l0["mlp"]["gate_proj"]["kernel"].shape[1]
    cfg = LlamaConfig(
        vocab_size=vocab, d_model=d_model, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, ff_dim=ff_dim,
        max_len=max_len, remat=False, dtype=dtype,
    )
    model = Llama(cfg, device=device)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model
