"""The head_dim 256 TransformerLM train step on one CUDA card, as
chip_smoke.py's lm_d256 phase builds it: d_model 1024 over 4 heads of
256, 2 layers, GPT-2 vocab, batch 2, seq 4096, the synthetic split's
ragged key padding, one forward and backward a step. Both steps run in
`--dtype` (default float32): "pallas" (the flash kernels: 2 forward, 2
dq and 2 dk/dv launches a step) and "xla" (the plain attention, no flash
kernel), on the same weights and batch, each step timed by CUDA events,
the two alternating step by step after one warm step each.

    python3 scripts/profile_torch_lm_d256.py [--root DIR] [--steps N]
                                             [--dtype float32|bfloat16]

`--root` runs another checkout of this repo (for example an older
commit unpacked with `git archive`): its `hyperion_tpu_torch` is
imported and built, while the inputs are this checkout's, so two
versions compare in one call on one card when the script runs old, new,
new, old; "xla" runs none of the kernels and is each run's control.
Prints the card's name and power limit, then one JSON line a run: each
impl's step times, their median, its loss and its flash launches a
step.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def load_smoke():
    """This checkout's chip_smoke.py (inputs), under its own name, so that
    `--root`'s package is the one imported."""
    spec = importlib.util.spec_from_file_location("smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        print("profile_torch_lm_d256: needs a CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    sys.path.insert(0, str(root))
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )
    from hyperion_tpu_torch.ops import flash_attention as fa
    from hyperion_tpu_torch.train.losses import next_token_loss

    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    B, T, H, D = cs.LM_D256_SHAPE
    kw = dict(vocab_size=50257, d_model=H * D, n_heads=H, n_layers=2,
              ff_dim=4 * H * D, max_len=T, dropout=0.0, dtype=args.dtype)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 47)
    models = {"pallas": TransformerLM(simple_lm_config(
        **kw, attention_impl="pallas"), device="cuda").init_params(g)}
    models["xla"] = TransformerLM(simple_lm_config(
        **kw, attention_impl="xla"), device="cuda")
    models["xla"].load_state_dict(models["pallas"].state_dict())
    ids = torch.randint(0, 50257, (B, T), generator=g, device="cuda")
    mask = cs.ragged_pad(B, T, cs.SEED + 47)

    def step(model):
        model.zero_grad(set_to_none=True)
        loss = next_token_loss(model(ids, padding_mask=mask), ids, mask)
        loss.backward()
        return loss

    counted = (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    rec = {"root": root.name, "dtype": args.dtype, "shape": [B, T],
           "heads": H, "head_dim": D, "layers": 2}
    for impl in models:
        rec[impl] = {"step_ms": []}
    for i in range(args.steps + 1):
        for impl, model in models.items():
            before = [f.launches for f in counted]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            loss = step(model)
            end.record()
            torch.cuda.synchronize()
            if i == 0:  # the warm step
                rec[impl]["loss"] = loss.item()
                rec[impl]["launches"] = {
                    f.__name__: f.launches - n
                    for f, n in zip(counted, before)}
            else:
                rec[impl]["step_ms"].append(start.elapsed_time(end))
    for impl in models:
        rec[impl]["median_ms"] = statistics.median(rec[impl]["step_ms"])
    print(json.dumps(rec), flush=True)
    want = {f.__name__: 2 for f in counted}
    if rec["pallas"]["launches"] != want:
        print(f"profile_torch_lm_d256: pallas launched "
              f"{rec['pallas']['launches']}, not {want}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
