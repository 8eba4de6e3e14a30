"""Sampling, generation and the inference CLI —
`hyperion_tpu/infer/generate.py` in PyTorch.

`generate` decodes one batch of aligned prompts: a prefill writes the
prompt's K/V into a contiguous cache sized to prompt + new tokens, then
one forward per new token. At temperature 0 it is argmax all the way,
and it is the serve engine's oracle: an engine stream at temperature 0
equals `generate` on the same prompt, token for token.
`generate_recompute` is the cache-free decode of any causal LM (the
TransformerLM exports the trainers write): one full forward over a
fixed-width buffer per new token, with the same contract.

`main` is the reference's inference CLI (`python -m
hyperion_tpu_torch.infer --ckpt X.npz --prompt ...`): `model_from_npz`
rebuilds the model from a gathered export, Llama exports decode through
`generate` and TransformerLM and MoE LM exports through
`generate_recompute` (pipeline exports raise, as the reference's do),
`--draft-ckpt` through `infer/speculative.py`. The reference wraps the
whole decode in one `jit`; the port runs it eagerly, on the card unless
`--device cpu`.

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


@torch.no_grad()
def generate_recompute(
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
    """Cache-free decoding for any causal LM (`generate`'s contract):
    re-runs the full forward over a fixed-width buffer [B, P +
    max_new_tokens] each step and takes the logits at the last filled
    position; causality keeps the zero future positions invisible."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, device is {dev}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 sampling needs a torch.Generator")
    ids = torch.as_tensor(np.asarray(prompt_ids), device=dev).long()
    B, P = ids.shape
    width = P + max_new_tokens
    if width > model.cfg.max_len:
        raise ValueError(f"{width} tokens exceeds max_len "
                         f"{model.cfg.max_len}")
    buf = torch.zeros(B, width, dtype=torch.long, device=dev)
    buf[:, :P] = ids
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for idx in range(P, width):
        logits = model(buf)
        logits = logits[0] if isinstance(logits, tuple) else logits
        nxt = sample_token(logits[:, idx - 1], generator, temperature, top_k,
                           top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        buf[:, idx] = nxt
        out.append(nxt)
    return torch.stack(out, dim=1)


def _lm_from_npz(params: dict, device):
    """A TransformerLM whose shape matches a gathered export, its
    weights loaded (`_infer_lm_from_npz` of the reference: the default
    fp32 config with the "xla" attention and norm, dropout off)."""
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        params_from_jax,
        simple_lm_config,
    )

    vocab, d_model = params["tok_emb"]["embedding"].shape
    cfg = simple_lm_config(
        vocab_size=vocab, d_model=d_model,
        n_layers=len([k for k in params if k.startswith("block_")]),
        ff_dim=params["block_0"]["fc1"]["kernel"].shape[1],
        n_heads=params["block_0"]["attn"]["q_proj"]["kernel"].shape[1],
        max_len=params["pos_emb"]["embedding"].shape[0], dropout=0.0)
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _moe_from_npz(params: dict, moe_top_k: int, device):
    """An MoE LM whose shape matches a gathered export, its weights
    loaded (`_infer_moe_from_npz` of the reference): the sparse block
    pattern and the expert bank from the weights, top_k from the caller
    (it is not in the weights), the default config's activation."""
    from hyperion_tpu_torch.models.moe_lm import MoELM, MoELMConfig
    from hyperion_tpu_torch.models.transformer_lm import (
        params_from_jax,
        simple_lm_config,
    )
    from hyperion_tpu_torch.ops.moe import MoEConfig

    vocab, d_model = params["tok_emb"]["embedding"].shape
    moe_idx = sorted(int(k.split("_")[-1]) for k in params
                     if k.startswith("moe_block_"))
    dense_idx = [int(k.split("_")[-1]) for k in params
                 if k.startswith("block_")]
    # blocks (i+1) % moe_every == 0 are sparse: the first sparse index
    # gives the cadence
    moe_every = moe_idx[0] + 1
    E, _, moe_ff = params[f"moe_block_{moe_idx[0]}"]["experts"]["wi"].shape
    first = (params[f"block_{dense_idx[0]}"] if dense_idx
             else params[f"moe_block_{moe_idx[0]}"])
    if not 1 <= moe_top_k <= E:
        raise ValueError(f"--moe-top-k {moe_top_k} out of range for this "
                         f"export's {E} experts (need 1..{E}, matching "
                         "training)")
    base = simple_lm_config(
        vocab_size=vocab, d_model=d_model,
        n_layers=len(moe_idx) + len(dense_idx),
        ff_dim=(params[f"block_{dense_idx[0]}"]["fc1"]["kernel"].shape[1]
                if dense_idx else moe_ff),
        n_heads=first["attn"]["q_proj"]["kernel"].shape[1],
        max_len=params["pos_emb"]["embedding"].shape[0], dropout=0.0)
    moe = MoEConfig(n_experts=E, top_k=moe_top_k, d_model=d_model,
                    ff_dim=moe_ff, activation=base.activation)
    model = MoELM(MoELMConfig(base=base, moe=moe, moe_every=moe_every),
                  device=device)
    model.load_state_dict(params_from_jax(params, base), strict=True)
    return model


def model_from_npz(params: dict, max_len: int = 4096, *,
                   dtype: str = "bfloat16", device=None,
                   moe_top_k: int = 2):
    """(model, cached) for a gathered export, its weights loaded: a
    Llama (cached: True, the KV-cache decode of `generate`), a
    TransformerLM or an MoE LM (False: `generate_recompute`; the MoE's
    routing `moe_top_k` is not in its weights). A Llama's max_len is
    not recoverable from its weights (RoPE has no table), so it is an
    argument, and `dtype` is its compute dtype (the reference's loader
    gives bfloat16); a TransformerLM takes both from its export.
    Pipeline exports raise, as the reference's CLI rejects them."""
    from hyperion_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        params_from_jax,
    )

    if "stages" in params:
        raise ValueError(
            "pipeline checkpoints are not supported by the generation "
            "CLI — export a dense TransformerLM, MoELM, or Llama "
            "checkpoint")
    if "embed_tokens" not in params:
        if any(k.startswith("moe_block_") for k in params):
            return _moe_from_npz(params, moe_top_k, device), False
        if "tok_emb" in params:
            return _lm_from_npz(params, device), False
        raise ValueError(f"unrecognized checkpoint layout (top-level keys: "
                         f"{sorted(params)[:6]}...)")
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
    return model, True


def main(argv=None) -> int:
    """The inference CLI (`:349-500` of the reference): decode one
    prompt from an export and print prompt + continuation."""
    import argparse
    import time

    from hyperion_tpu_torch.checkpoint.io import load_gathered
    from hyperion_tpu_torch.data.bpe import ByteBPE
    from hyperion_tpu_torch.obs import heartbeat as obs_heartbeat
    from hyperion_tpu_torch.obs import trace as obs_trace
    from hyperion_tpu_torch.obs.registry import (
        MetricsRegistry,
        observe_step,
        observe_throughput,
    )

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prompt", required=True)
    p.add_argument("--ckpt", default="data/checkpoints/language_ddp_final.npz",
                   help="gathered-export .npz (written by the trainers)")
    p.add_argument("--tokenizer-dir", default="data/tokenizer")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling: keep the smallest prefix of "
                        "the distribution reaching this mass (1.0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-len", type=int, default=4096,
                   help="context length for Llama exports (RoPE has no "
                        "weight table to infer it from)")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="int8 = weight-only quantized decode (ROADMAP A9b)")
    p.add_argument("--draft-ckpt", default=None,
                   help="speculative decoding: a smaller Llama export "
                        "whose proposals the main model verifies (greedy "
                        "only; same vocab; infer/speculative.py)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="speculative proposals per verify round")
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="MoE exports: routing top_k (not recoverable from "
                        "weights — match training)")
    p.add_argument("--device", default="cuda",
                   help="torch device (the plain PyTorch path runs with "
                        "--device cpu)")
    args = p.parse_args(argv)
    if args.quant == "int8":
        raise SystemExit("--quant int8 is not ported yet: the int8 decode "
                         "needs its own GEMM kernel (ROADMAP A9b)")
    dev = resolve_device(args.device)

    # decode telemetry (opt-in: HYPERION_TELEMETRY=1 or =<path>): the
    # load and decode spans and a tokens/s gauge, the trainers' stream
    # format; a timestamped run id keeps each invocation separable
    tracer = obs_trace.from_env("data/telemetry.jsonl",
                                run=f"generate_{int(time.time())}")
    hb = obs_heartbeat.Heartbeat.for_tracer(tracer)
    hb.pulse(phase="load")
    reg = MetricsRegistry()

    with tracer.span("load") as ld:
        tok = ByteBPE.load(args.tokenizer_dir)
        params = load_gathered(args.ckpt)
        model, cached = model_from_npz(params, args.max_len, device=dev,
                                       moe_top_k=args.moe_top_k)
        ld.set(ckpt=args.ckpt, cached=cached)
    draft_model = None
    if args.draft_ckpt:
        if not cached:
            raise SystemExit("--draft-ckpt needs a Llama (KV-cache) target")
        if args.temperature > 0:
            raise SystemExit(
                "speculative decoding is greedy-only; drop --temperature")
        draft_model, draft_cached = model_from_npz(
            load_gathered(args.draft_ckpt), args.max_len, device=dev)
        if not draft_cached:
            raise SystemExit("--draft-ckpt must be a Llama export")
        if args.draft_k < 1:
            raise SystemExit("--draft-k must be >= 1")
        n_prompt = len(tok.encode(args.prompt))
        if n_prompt <= args.draft_k:
            raise SystemExit(
                f"prompt encodes to {n_prompt} tokens but speculative "
                f"decoding needs more than --draft-k={args.draft_k} — "
                "use a longer prompt or a smaller k")
    if tok.vocab_size > model.cfg.vocab_size:
        print(f"[generate] warning: tokenizer vocab {tok.vocab_size} exceeds "
              f"model vocab {model.cfg.vocab_size} — prompt ids above the "
              "model's range would be out of the embedding's range; "
              "retrain the tokenizer at or below the model vocab")
    ids = [tok.encode(args.prompt)]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    hb.pulse(phase="decode", tokens_requested=args.max_new_tokens)
    with tracer.span("decode_step", step=0) as sp:
        if draft_model is not None:
            from hyperion_tpu_torch.infer.speculative import (
                generate_speculative,
            )

            out = generate_speculative(
                model, draft_model, ids, args.max_new_tokens, k=args.draft_k,
                eos_id=tok.eos_id, pad_id=tok.eos_id, device=dev)
        else:
            decode = generate if cached else generate_recompute
            out = decode(model, ids, args.max_new_tokens, eos_id=tok.eos_id,
                         pad_id=tok.eos_id, temperature=args.temperature,
                         top_k=args.top_k, top_p=args.top_p, generator=gen,
                         device=dev)
        out_host = out.cpu().numpy()  # the copy back is the fence
        n_new = int(out_host.size)
        sp.set(tokens=n_new)
    dur = max(sp.dur_s, 1e-9)
    observe_step(reg, dur, tokens=n_new)
    observe_throughput(reg, dur, 1, tokens=n_new)
    tracer.snapshot(reg)
    tracer.event("generate_done", tokens=n_new,
                 tokens_per_s=reg.gauge("tokens_per_s").value)
    hb.close(phase="done", tokens=n_new)
    tracer.close()
    text = tok.decode([int(t) for t in out_host[0] if t != tok.eos_id])
    print(args.prompt + text)
    return 0
