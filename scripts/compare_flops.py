"""One train step's FLOPs: the port's count against the JAX package's.

    JAX_PLATFORMS=cpu python scripts/compare_flops.py

The port counts a step's products with `torch.utils.flop_counter` on a
meta-device twin of the model (`hyperion_tpu_torch/obs/registry.py`
`compiled_flops`); the reference asks XLA's cost analysis of the
compiled step (`hyperion_tpu/obs/registry.py` `compiled_flops`), which
also counts elementwise work and the optimizer's update. This prints
both for the same step, and their ratio, for language_ddp at its
published widths (seq 128, batch 32, bf16 policy), llama_tiny (full
fine-tune) and llama_tiny with LoRA, both at seq 64, batch 2, and the
cifar job's ResNet-18 (batch 64, bf16 policy; the convolutions are
products in both counts); the JAX steps at tier "jit", whose attention
XLA sees (a Pallas call's products are not in its count). Nothing runs
a step: XLA compiles each for the CPU, and the port's count is shapes
only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def jax_step_flops(model, init_variables, loss_kind: str, B: int, T: int,
                   policy: str, lora: bool = False) -> float | None:
    import optax

    from hyperion_tpu.models.lora import structural_merge
    from hyperion_tpu.obs.registry import compiled_flops
    from hyperion_tpu.runtime.mesh import MeshSpec, make_mesh
    from hyperion_tpu.train.losses import next_token_loss
    from hyperion_tpu.train.state import create_train_state, make_optimizer
    from hyperion_tpu.train.step import make_train_step

    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    opt = make_optimizer(1e-3)
    if lora:
        opt = optax.multi_transform(
            {"train": opt, "freeze": optax.set_to_zero()},
            param_labels={"base": "freeze", "lora": "train"})
    state, sharding = create_train_state(init_variables, opt, mesh,
                                         jax.random.key(0), policy=policy,
                                         fsdp=False)

    def loss_fn(params, batch_stats, batch, rngs):
        if lora:
            base = jax.tree.map(jax.lax.stop_gradient, params["base"])
            params = structural_merge(base, params["lora"])
        kw = ({"deterministic": rngs is None, "rngs": rngs}
              if loss_kind == "lm" else {})
        logits = model.apply({"params": params}, batch["input_ids"],
                             padding_mask=batch["attention_mask"], **kw)
        loss = next_token_loss(logits, batch["input_ids"],
                               batch["attention_mask"])
        return loss, ({"loss": loss}, batch_stats)

    step = make_train_step(loss_fn, opt, sharding, donate=False,
                           dropout=loss_kind == "lm")
    batch = {"input_ids": jnp.zeros((B, T), jnp.int32),
             "attention_mask": jnp.ones((B, T), jnp.int8)}
    return compiled_flops(step, state, batch, jax.random.key(1))


def port_step_flops(model, B: int, T: int) -> float | None:
    from hyperion_tpu_torch.obs.registry import compiled_flops
    from hyperion_tpu_torch.train.losses import next_token_loss

    def loss(m, b):
        logits = m(b["input_ids"], padding_mask=b["attention_mask"])
        return next_token_loss(logits, b["input_ids"], b["attention_mask"])

    batch = {"input_ids": torch.zeros(B, T, dtype=torch.int32),
             "attention_mask": torch.ones(B, T, dtype=torch.int8)}
    return compiled_flops(model, loss, batch)


def language_ddp() -> dict:
    from hyperion_tpu.models import transformer_lm as jlm
    from hyperion_tpu_torch.models import transformer_lm as tlm

    B, T = 32, 128
    jmodel = jlm.TransformerLM(jlm.simple_lm_config(
        max_len=T, dropout=0.1, dtype="bfloat16", attention_impl="xla"))
    ref = jax_step_flops(jmodel, lambda r: {"params": jmodel.init_params(r)},
                         "lm", B, T, "bf16")
    model = tlm.TransformerLM(tlm.simple_lm_config(
        max_len=T, dropout=0.1, dtype="bfloat16", attention_impl="xla"),
        device="meta")
    return {"step": "language_ddp [32, 128] bf16", "jax": ref,
            "port": port_step_flops(model, B, T)}


def llama_tiny(lora: bool) -> dict:
    from hyperion_tpu.models import llama as jl
    from hyperion_tpu.models.lora import LoraConfig, init_lora_params
    from hyperion_tpu.models.lora import target_module_names
    from hyperion_tpu_torch.models import llama as tl

    B, T = 2, 64
    jcfg = jl.llama_tiny_config(max_len=T)
    jmodel = jl.Llama(jcfg)
    lcfg = LoraConfig(rank=4, alpha=8.0)

    def init(r):
        base = jmodel.init_params(r, seq=T)
        if not lora:
            return {"params": base}
        return {"params": {"base": base, "lora": init_lora_params(
            jax.random.fold_in(r, 1), base, lcfg)}}

    if lora:
        names = target_module_names(init(jax.random.key(0))["params"]["lora"])
        jmodel = jl.Llama(dataclasses.replace(
            jcfg, lora_rank=lcfg.rank, lora_scale=lcfg.scale,
            lora_targets=names))
    ref = jax_step_flops(jmodel, init, "llama", B, T, "fp32", lora=lora)
    cfg = tl.llama_tiny_config(max_len=T)
    if lora:
        cfg = dataclasses.replace(cfg, lora_rank=4, lora_scale=2.0,
                                  lora_targets=tuple(names))
    model = tl.Llama(cfg, device="meta")
    for n, p in model.named_parameters():
        p.requires_grad_(not lora or n.endswith(("lora_a", "lora_b")))
    return {"step": f"llama_tiny [2, 64] fp32, {'LoRA' if lora else 'full'}",
            "jax": ref, "port": port_step_flops(model, B, T)}


def cifar() -> dict:
    """The cifar job's step: ResNet-18 at batch 64 under "bf16", the
    reference's `classification_loss` over BatchNorm's batch
    statistics."""
    from hyperion_tpu.models.resnet import resnet18 as jax_resnet18
    from hyperion_tpu.obs.registry import compiled_flops as jax_flops
    from hyperion_tpu.runtime.mesh import MeshSpec, make_mesh
    from hyperion_tpu.train.losses import classification_loss as jax_loss
    from hyperion_tpu.train.state import create_train_state, make_optimizer
    from hyperion_tpu.train.step import make_train_step
    from hyperion_tpu_torch.models.resnet import resnet18
    from hyperion_tpu_torch.obs.registry import compiled_flops
    from hyperion_tpu_torch.train.losses import classification_loss
    from hyperion_tpu_torch.train.trainer import nchw

    B = 64
    jmodel = jax_resnet18(dtype="bfloat16")
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    opt = make_optimizer(1e-3)
    state, sharding = create_train_state(jmodel.init_variables, opt, mesh,
                                         jax.random.key(0), policy="bf16",
                                         fsdp=False)

    def loss_fn(params, batch_stats, batch, rngs):
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, batch["images"],
            train=True, mutable=["batch_stats"])
        loss, counts = jax_loss(logits, batch["labels"])
        return loss, ({"loss": loss, **counts}, mut["batch_stats"])

    step = make_train_step(loss_fn, opt, sharding, donate=False)
    batch = {"images": jnp.zeros((B, 32, 32, 3), jnp.float32),
             "labels": jnp.zeros((B,), jnp.int32)}
    ref = jax_flops(step, state, batch, jax.random.key(1))
    model = resnet18(dtype="bfloat16", device="meta")

    def loss(m, b):
        return classification_loss(m(nchw(b["images"]), train=True),
                                   b["labels"])[0]

    port = compiled_flops(model, loss, {
        "images": torch.zeros(B, 32, 32, 3),
        "labels": torch.zeros(B, dtype=torch.int64)})
    return {"step": "cifar ResNet-18 [64, 32, 32, 3] bf16", "jax": ref,
            "port": port}


def main() -> int:
    rows = [language_ddp(), llama_tiny(False), llama_tiny(True), cifar()]
    for r in rows:
        r["port_over_jax"] = (r["port"] / r["jax"]
                              if r["port"] and r["jax"] else None)
        print(json.dumps(r), flush=True)
    return 0 if all(r["port_over_jax"] for r in rows) else 1


if __name__ == "__main__":
    np.seterr(all="ignore")
    raise SystemExit(main())
