"""Where a train-state checkpoint's time goes on the card: the Llama-2-7B
LoRA state (the bf16 base, the adapters and their AdamW moments) and
the language_ddp state, through `hyperion_tpu_torch/checkpoint/io.py`.

    python3 scripts/profile_torch_ckpt.py [--skip-7b]

For each state, in turns: the host snapshot into pinned buffers (first
call, which allocates them, then reused), the same copies into
pageable memory (`Tensor.to("cpu")`, synchronous), the write
(`torch.save` of the single-process shard file), the manifest
(sha256 of every byte), and a restore (deep verify and load). Prints
one JSON line per state, with the card's name and power limit. Writes
under `build/profile_torch_ckpt/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "profile_torch_ckpt"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _secs(fn) -> tuple[float, object]:
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return time.perf_counter() - t0, out


def profile(name: str, state) -> dict:
    from hyperion_tpu_torch.checkpoint import integrity
    from hyperion_tpu_torch.checkpoint import io as ckpt

    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    tree = ckpt._shard_tree(state)
    ckpt.release_host_buffers()
    rec = {"state": name}
    rec["pinned_first_s"], _ = _secs(lambda: ckpt._snapshot(tree))
    rec["pinned_reused_s"], host = _secs(lambda: ckpt._snapshot(tree))

    def pageable(t):
        if isinstance(t, torch.Tensor):
            return t.detach().to("cpu")
        if isinstance(t, dict):
            return {k: pageable(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(pageable(v) for v in t)
        return t

    rec["pageable_s"], _ = _secs(lambda: pageable(tree))
    path = ckpt._step_path(root, state.step)
    rec["write_s"], _ = _secs(lambda: ckpt._write_shard(path, host, None))
    rec["manifest_s"], _ = _secs(lambda: integrity.write_manifest(
        path, state.step, state))
    rec["bytes"] = sum(p.stat().st_size for p in path.iterdir())
    rec["restore_s"], restored = _secs(lambda: ckpt.restore(root, state))
    rec["restored_step"] = restored.step if restored is not None else None
    ckpt.release_host_buffers()
    shutil.rmtree(root, ignore_errors=True)
    return rec


def llama_state():
    from hyperion_tpu_torch.models import llama as ll
    from hyperion_tpu_torch.models import lora as lm
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer
    from hyperion_tpu_torch.train.step import seeded_generator

    cfg = ll.llama2_7b_config(max_len=4096)
    lcfg = lm.LoraConfig(rank=16, alpha=32.0)
    lora = lm.init_lora_params(seeded_generator("cuda", 0, 1),
                               ll.jax_kernel_shapes(cfg), lcfg)
    cfg = dataclasses.replace(cfg, lora_rank=16, lora_scale=lcfg.scale,
                              lora_targets=lm.target_module_names(lora))
    model = ll.Llama(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    model.load_lora(lora)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    opt = make_optimizer(model.parameters(), 1e-5, 0.01, 1.0)
    for p in opt.params:  # moments exist, as after a step
        p.grad = torch.zeros_like(p)
    opt.step()
    return TrainState(1, model, opt)


def lm_state():
    from hyperion_tpu_torch.models import transformer_lm as tl
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer

    model = tl.TransformerLM(tl.simple_lm_config(dtype="bfloat16"),
                             device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    opt = make_optimizer(model.parameters(), 2e-4)
    for p in opt.params:
        p.grad = torch.zeros_like(p)
    opt.step()
    return TrainState(1, model, opt)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--skip-7b", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_ckpt: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    states = [("language_ddp", lm_state)]
    if not args.skip_7b:
        states.append(("llama_7b_lora", llama_state))
    for name, make in states:
        state = make()
        print(json.dumps({**profile(name, state), "nvidia_smi": smi}),
              flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
