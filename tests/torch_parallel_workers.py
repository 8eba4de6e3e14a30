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


def cifar_run(r: dict) -> dict:
    """A narrow ResNet (`cfg`: `ResNetConfig` kwargs) from the flax
    `variables`, trained on `batches` (global NHWC images and labels)
    under a (data, fsdp, model) `mesh` (None: one process) with every
    BatchNorm's statistics global over the batch ranks, `grad_accum`
    microbatches a step (default 1): per step the global loss
    and the summed `correct` and `total`, and on rank 0 the final
    params and batch_stats in the flax layout."""
    import torch

    from hyperion_tpu_torch.checkpoint.io import gathered_state
    from hyperion_tpu_torch.models import resnet as tr
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import batch_rows
    from hyperion_tpu_torch.train.losses import classification_loss
    from hyperion_tpu_torch.train.step import make_train_step
    from hyperion_tpu_torch.train.trainer import nchw

    mesh = _mesh(r["mesh"])
    model = tr.ResNet(tr.ResNetConfig(**r["cfg"]), device="cpu")
    model.load_state_dict(tr.params_from_jax(r["variables"]))
    state, sync, gs = _state(model, mesh, False, r["lr"], 0.0, 0.0)
    model.set_batch_groups(sync.groups)

    def loss_fn(m, b, gen):
        loss, counts = classification_loss(m(nchw(b["images"]), train=True),
                                           b["labels"], sync=sync)
        return loss, {"loss": loss, **counts}

    step = make_train_step(loss_fn, grad_accum=r.get("grad_accum", 1),
                           sync=sync, grad_sync=gs)
    out = {"losses": [], "correct": [], "total": []}
    for images, labels in r["batches"]:
        rows = slice(None) if mesh is None else batch_rows(mesh, len(images))
        m = step(state, {"images": torch.from_numpy(images[rows]),
                         "labels": torch.from_numpy(labels[rows])}, 0)
        out["losses"].append(float(m["loss"]))
        out["correct"].append(float(m["correct"]))
        out["total"].append(float(m["total"]))
    named = gathered_state(model)
    out["state"] = tr.state_to_jax(named) if dist.is_primary() else None
    return out


# --- the seq, pipe and expert axes, and Llama tensor parallelism -----


def _axes_mesh(shape):
    """A mesh over all six axes (data, fsdp, model, seq, pipe, expert),
    registered active; None in a single process."""
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
        set_active_mesh,
    )

    if not dist.is_distributed():
        set_active_mesh(None)
        return None
    mesh = make_mesh(MeshSpec(*shape), "cpu")
    set_active_mesh(mesh)
    return mesh


def axes_model(r: dict):
    """The port's model of a run: `kind` "lm" (TransformerLM), "pipe"
    (PipelinedLM, `stages` x `micro`), "moe" (MoELM, `moe` MoEConfig
    kwargs, `moe_every`) or "llama" (a tiny fp32 Llama), its weights
    from the flax `params`."""
    import torch

    from hyperion_tpu_torch.models import llama as ll
    from hyperion_tpu_torch.models import pipeline_lm as pl
    from hyperion_tpu_torch.models import transformer_lm as tt
    from hyperion_tpu_torch.models.moe_lm import MoELM, MoELMConfig
    from hyperion_tpu_torch.ops.moe import MoEConfig

    kind, params = r.get("kind", "lm"), r["params"]
    if kind == "llama":
        cfg = ll.llama_tiny_config(**r["cfg"])
        model = ll.Llama(cfg, device="cpu")
        model.load_state_dict(ll.params_from_jax(params, cfg), strict=False)
        for p in model.parameters():
            p.requires_grad_(True)
        return model
    cfg = tt.simple_lm_config(**r["cfg"])
    if kind == "pipe":
        model = pl.PipelinedLM(pl.PipelineLMConfig(
            cfg, r["stages"], r["micro"]), device="cpu")
        model.load_state_dict(pl.params_from_jax(params, model.pipe_cfg))
    elif kind == "moe":
        model = MoELM(MoELMConfig(cfg, MoEConfig(**r["moe"]),
                                  moe_every=r["moe_every"]), device="cpu")
        model.load_state_dict(tt.params_from_jax(params, cfg))
    else:
        model = tt.TransformerLM(cfg, device="cpu")
        model.load_state_dict(tt.params_from_jax(params, cfg))
    return model.to(torch.float32)


def axes_batch(mesh, ids, mask) -> dict:
    """This rank's piece of a global batch as the language trainer
    shards it (`data/sharding.py`): rows over (data, fsdp, expert), and
    under a seq axis each row's slice with its next-token targets."""
    import torch

    from hyperion_tpu_torch.data.sharding import next_tokens
    from hyperion_tpu_torch.runtime.mesh import (
        AxisName,
        axis_sizes,
        batch_rows,
        seq_cols,
    )

    arrays = {"input_ids": ids, "attention_mask": mask}
    if mesh is None:
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    rows = batch_rows(mesh, len(ids), AxisName.LM_ROWS)
    cols = slice(None)
    if axis_sizes(mesh)[AxisName.SEQ] > 1:
        arrays.update(next_tokens(arrays))
        cols = seq_cols(mesh, ids.shape[1])
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows, cols]))
            for k, v in arrays.items()}


def axes_run(r: dict) -> dict:
    """Train `batches` (global ids and masks) with the language trainer's
    layout on the six-axis `mesh` (`fsdp`: FSDP2 over the batch axes,
    else DDP) and loss (`train/trainer.py`: the LM loss, plus the MoE
    aux): per step the loss and grad norm (and for an MoE the aux), and
    on rank 0 the final parameters in the flax layout."""
    from hyperion_tpu_torch.checkpoint.io import gathered_state
    from hyperion_tpu_torch.models import llama as ll
    from hyperion_tpu_torch.models import pipeline_lm as pl
    from hyperion_tpu_torch.models import transformer_lm as tt
    from hyperion_tpu_torch.models.moe_lm import MoELM
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import AxisName
    from hyperion_tpu_torch.train.losses import lm_loss
    from hyperion_tpu_torch.train.state import TrainState, make_optimizer
    from hyperion_tpu_torch.train.step import make_train_step
    from hyperion_tpu_torch.train.trainer import _parallelize

    mesh = _axes_mesh(r["mesh"])
    model = axes_model(r)
    blocks = model.layers if r.get("kind") == "llama" else model.blocks
    sync, gs = _parallelize(model, mesh, r["fsdp"], blocks,
                            AxisName.LM_REPLICAS)
    opt = make_optimizer(model.parameters(), r["lr"], r["wd"], r["clip"])
    state = TrainState(0, model, opt)
    moe = isinstance(model, MoELM)

    def loss_fn(m, b, gen):
        if moe:
            logits, aux = m.apply_with_aux(b["input_ids"],
                                           padding_mask=b["attention_mask"])
        else:
            logits = m(b["input_ids"], padding_mask=b["attention_mask"])
            aux = 0.0
        loss = lm_loss(logits, b, sync=sync) + aux
        return loss, ({"loss": loss, "aux": aux} if moe else {"loss": loss})

    step = make_train_step(loss_fn, sync=sync, grad_sync=gs)
    out = {"losses": [], "norms": [], "aux": []}
    for ids, mask in r["batches"]:
        m = step(state, axes_batch(mesh, ids, mask), 0)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        if moe:
            out["aux"].append(float(m["aux"]))
    named = gathered_state(model)
    if dist.is_primary():
        kind = r.get("kind", "lm")
        out["params"] = (ll.params_to_jax(model, named) if kind == "llama"
                         else pl.state_to_jax(named, model.pipe_cfg)
                         if kind == "pipe" else tt.state_to_jax(named,
                                                                model.cfg))
    return out


def axes_runs(runs: list[dict]) -> list[dict]:
    return [axes_run(r) for r in runs]


def seq_attention_runs(cases: list[dict]) -> list[dict]:
    """Each case: `impl` ("ring" | "ulysses"), `causal`, global [B, T,
    H, D] fp32 `q`, `k`, `v`, `do` and a [B, T] `pad`, on a mesh of the
    world on seq: this rank's slice of the attention output and of the
    gradients of sum(out * do) w.r.t. q, k and v."""
    import torch

    from hyperion_tpu_torch.ops.attention import dot_product_attention
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import seq_cols

    mesh = _axes_mesh((1, 1, 1, dist.process_count(), 1, 1))
    out = []
    for c in cases:
        cols = seq_cols(mesh, c["q"].shape[1])
        q, k, v = (torch.from_numpy(np.ascontiguousarray(c[n][:, cols]))
                   .requires_grad_() for n in ("q", "k", "v"))
        pad = None if c["pad"] is None else torch.from_numpy(
            np.ascontiguousarray(c["pad"][:, cols]))
        o = dot_product_attention(q, k, v, causal=c["causal"],
                                  padding_mask=pad, impl=c["impl"])
        (o * torch.from_numpy(np.ascontiguousarray(c["do"][:, cols]))
         ).sum().backward()
        out.append({"out": o.detach().numpy(), "dq": q.grad.numpy(),
                    "dk": k.grad.numpy(), "dv": v.grad.numpy()})
    return out


def gpipe_runs(cases: list[dict]) -> list[dict]:
    """`parallel.pipeline.gpipe_apply` on a mesh of the world on pipe,
    each case a stage of `layers` tanh layers (x @ w[s, l]) per stage
    over `micro` microbatches of `x` [B, d], every stage's w [S, L, d, d]
    given whole: the output and the gradients of this stage's share of
    sum(out * g) w.r.t. x (stage 0's is the input's) and its w."""
    import torch

    from hyperion_tpu_torch.parallel.pipeline import gpipe_apply
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import AxisName

    S = dist.process_count()
    mesh = _axes_mesh((1, 1, 1, 1, S, 1))
    s = dist.process_index()
    out = []
    for c in cases:
        x = torch.from_numpy(c["x"]).requires_grad_()
        w = torch.from_numpy(c["w"][s]).requires_grad_()
        mask = torch.from_numpy(c["mask"])

        def stage_fn(params, x_mb, extras, m):
            for lw in params[0]:
                x_mb = torch.tanh(x_mb @ lw) * extras[0][:, None]
            return x_mb

        y = gpipe_apply(stage_fn, [w], x, mesh.get_group(AxisName.PIPE),
                        n_microbatches=c["micro"], extras=[mask])
        # every stage holds the output, so each takes 1/S of the
        # objective, as the trainer's loss shares over `pipe` do
        ((y * torch.from_numpy(c["g"])).sum() / S).backward()
        out.append({"y": y.detach().numpy(), "dx": x.grad.numpy(),
                    "dw": w.grad.numpy()})
    return out


def moe_ep_runs(cases: list[dict]) -> list[dict]:
    """`ops.moe.moe_ffn` on a mesh of the world on expert: each case a
    layer's flax `params` (router kernel, stacked experts), `cfg`
    (MoEConfig kwargs), global `x` [B, T, d], `mask` [B, T] and `g`;
    each rank takes its rows of x (the batch split over the expert
    axis) and its E/n experts. This rank's y rows, the aux loss, and
    the gradients of its share of sum(y * g) + aux w.r.t. its x rows,
    the router (the ranks' sum is the router's) and its experts."""
    import torch

    from hyperion_tpu_torch.ops.moe import MoEConfig, moe_ffn
    from hyperion_tpu_torch.runtime import dist
    from hyperion_tpu_torch.runtime.mesh import (
        AxisName,
        axis_groups,
        batch_rows,
    )

    n = dist.process_count()
    mesh = _axes_mesh((1, 1, 1, 1, 1, n))
    r = dist.process_index()
    out = []
    for c in cases:
        cfg = MoEConfig(**c["cfg"])
        rows = batch_rows(mesh, len(c["x"]), AxisName.LM_ROWS)
        E = cfg.n_experts // n
        x = torch.from_numpy(c["x"][rows]).requires_grad_()
        router = torch.from_numpy(c["params"]["router"]["kernel"]) \
            .requires_grad_()
        experts = {k: torch.from_numpy(np.ascontiguousarray(
            v[r * E:(r + 1) * E])).requires_grad_()
            for k, v in c["params"]["experts"].items()}
        y, aux = moe_ffn({"router": {"kernel": router}, "experts": experts},
                         x, cfg, torch.from_numpy(c["mask"][rows]),
                         expert_group=mesh.get_group(AxisName.EXPERT),
                         row_groups=axis_groups(mesh, AxisName.LM_ROWS))
        # each rank holds the global aux: its share of the objective
        # sum(y * g) + aux is its rows' sum and aux / n
        ((y * torch.from_numpy(c["g"][rows])).sum() + aux / n).backward()
        out.append({"y": y.detach().numpy(), "aux": float(aux.detach()),
                    "dx": x.grad.numpy(), "drouter": router.grad.numpy(),
                    "dexperts": {k: v.grad.numpy()
                                 for k, v in experts.items()}})
    return out
