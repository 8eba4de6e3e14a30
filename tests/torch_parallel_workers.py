"""Rank functions of the port's multi-rank CPU tests.

`hyperion_tpu_torch/testing/ranks.py` runs each on a world of spawned
gloo ranks, and a spawned rank imports its function's module: this one
imports neither jax nor the JAX package, so a rank starts with torch
alone. Inputs are numpy (weights in the flax layout, batches as the
global [B, T] arrays); each returns numpy, the whole tensors on rank 0.
"""

from __future__ import annotations

import numpy as np


def _lm_model(cfg_kw: dict, params: dict | None):
    import torch

    from hyperion_tpu_torch.models import transformer_lm as tt

    cfg = tt.simple_lm_config(**cfg_kw)
    model = tt.TransformerLM(cfg, device="cpu")
    if params is None:
        model.init_params(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(tt.params_from_jax(params, cfg))
    return model


def _llama_model(cfg_kw: dict, params: dict):
    import torch

    from hyperion_tpu_torch.models import llama as ll

    cfg = ll.llama_tiny_config(**cfg_kw)
    model = ll.Llama(cfg, device="cpu")
    model.load_state_dict(ll.params_from_jax(params, cfg), strict=False)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
            p.requires_grad_(True)
    return model


def _mesh(shape):
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
        set_active_mesh,
    )

    if not dist.is_distributed():
        return None
    d, f, m = shape
    mesh = make_mesh(MeshSpec(data=d, fsdp=f, model=m), "cpu")
    set_active_mesh(mesh)  # as the trainers register theirs
    return mesh


def _state(model, mesh, fsdp: bool, lr: float, clip: float, wd: float):
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer
    from hyperion_tpu_torch.train.trainer import _parallelize

    blocks = model.blocks if hasattr(model, "blocks") else model.layers
    sync, grad_sync = _parallelize(model, mesh, fsdp, blocks)
    opt = make_optimizer(model.parameters(), lr, wd, clip)
    return TrainState(0, model, opt), sync, grad_sync


def _train(state, sync, grad_sync, mesh, batches):
    import torch

    from hyperion_tpu_torch.runtime.mesh import batch_rows
    from hyperion_tpu_torch.train.losses import next_token_loss
    from hyperion_tpu_torch.train.step import make_train_step

    def loss_fn(model, b, gen):
        logits = model(b["input_ids"], padding_mask=b["attention_mask"])
        loss = next_token_loss(logits, b["input_ids"], b["attention_mask"],
                               sync=sync)
        return loss, {"loss": loss}

    step = make_train_step(loss_fn, sync=sync, grad_sync=grad_sync)
    losses, norms = [], []
    for ids, mask in batches:
        rows = slice(None) if mesh is None else batch_rows(mesh, len(ids))
        m = step(state, {"input_ids": torch.from_numpy(ids[rows]),
                         "attention_mask": torch.from_numpy(mask[rows])}, 0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def lm_runs(runs: list[dict]) -> list[dict]:
    """Each run: `mesh` (data, fsdp, model), `fsdp`, `cfg` (the
    TransformerLM's kwargs), `params` (flax tree), `batches`, `lr`,
    `clip`, `wd`. Per run: the per-step losses and grad norms, and on
    rank 0 the final parameters in the flax layout."""
    from hyperion_tpu_torch.checkpoint.io import gathered_state
    from hyperion_tpu_torch.models.transformer_lm import state_to_jax
    from hyperion_tpu_torch.runtime import dist

    out = []
    for r in runs:
        model = _lm_model(r["cfg"], r["params"])
        mesh = _mesh(r["mesh"])
        state, sync, gs = _state(model, mesh, r["fsdp"], r["lr"], r["clip"],
                                 r["wd"])
        losses, norms = _train(state, sync, gs, mesh, r["batches"])
        named = gathered_state(model)
        out.append({"losses": losses, "norms": norms,
                    "params": state_to_jax(named, model.cfg)
                    if dist.is_primary() else None})
    return out


def llama_run(r: dict) -> dict:
    """A tiny Llama full fine-tune (bf16 params, FSDP over `mesh`): the
    per-step losses."""
    mesh = _mesh(r["mesh"])
    model = _llama_model(r["cfg"], r["params"])
    state, sync, gs = _state(model, mesh, True, r["lr"], r["clip"], r["wd"])
    losses, norms = _train(state, sync, gs, mesh, r["batches"])
    return {"losses": losses, "norms": norms}


def full_state(state) -> dict:
    """Every tensor of a TrainState whole, on the CPU, by name (a
    collective under a mesh): the model's state dict, each trained
    parameter's AdamW moments and step, the update count and step."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().cpu().clone()

    out = {f"model/{k}": whole(v)
           for k, v in state.model.state_dict().items()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p in state.optimizer.params:
        for k, v in state.optimizer.adamw.state.get(p, {}).items():
            out[f"adamw/{names[id(p)]}/{k}"] = whole(v)
    out["count"] = state.optimizer.count
    out["step"] = state.step
    return out


def ckpt_save_run(r: dict) -> dict | None:
    """Train `batches` under `mesh` (FSDP), save the sharded checkpoint
    to `root` (async, then the commit point) and export the gathered
    parameters to `export`; rank 0 returns the whole state."""
    from hyperion_tpu_torch.checkpoint import io as ckpt
    from hyperion_tpu_torch.models.transformer_lm import state_to_jax
    from hyperion_tpu_torch.runtime import dist

    model = _lm_model(r["cfg"], r["params"])
    mesh = _mesh(r["mesh"])
    state, sync, gs = _state(model, mesh, r["fsdp"], 1e-3, 1.0, 0.01)
    _train(state, sync, gs, mesh, r["batches"])
    ckpt.save(r["root"], state, wait=False)
    ckpt.wait_pending()
    named = ckpt.gathered_state(model)
    if dist.is_primary():
        ckpt.export_gathered(r["export"], state_to_jax(named, model.cfg))
    whole = full_state(state)
    return whole if dist.is_primary() else None


def ckpt_restore_run(r: dict) -> dict | None:
    """A fresh state under `mesh` (FSDP when `fsdp`), restored from
    `root`; rank 0 returns the whole state."""
    from hyperion_tpu_torch.checkpoint import io as ckpt
    from hyperion_tpu_torch.runtime import dist

    model = _lm_model(r["cfg"], None)
    mesh = _mesh(r["mesh"])
    state, _, _ = _state(model, mesh, r["fsdp"], 1e-3, 1.0, 0.01)
    restored = ckpt.restore(r["root"], state)
    assert restored is not None
    whole = full_state(state)
    return whole if dist.is_primary() else None


def comm_check_run() -> dict:
    from hyperion_tpu_torch.runtime.comm_check import comm_check

    return comm_check(verbose=False)


def agree_run(flags: list[bool]) -> list:
    """`any_rank` of this rank's flag, the host barrier and the process
    counts, as every rank sees them."""
    from hyperion_tpu_torch.runtime import dist

    rank = dist.process_index()
    agreed = dist.any_rank(flags[rank])
    dist.barrier("agree")
    return [agreed, dist.process_count(), dist.peers_alive(),
            dist.is_primary()]


def coord_ok(port: int, rank: int, rounds: int) -> None:
    """A host-coordinator worker: join, pass `rounds` barriers, close."""
    from hyperion_tpu_torch.runtime.native_coord import HostCoordinator

    with HostCoordinator(rank, 3, port=port, timeout_s=20) as c:
        for _ in range(rounds):
            c.barrier(timeout_s=20)


def coord_dies(port: int, rank: int) -> None:
    """A host-coordinator worker that exits right after joining."""
    import os

    from hyperion_tpu_torch.runtime.native_coord import HostCoordinator

    c = HostCoordinator(rank, 3, port=port, timeout_s=20)
    del c
    os._exit(0)
