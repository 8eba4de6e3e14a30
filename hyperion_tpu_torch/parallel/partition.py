"""Parameter partitioning — `hyperion_tpu/parallel/partition.py`, and
the appliers that lay a torch model out by it.

The JAX package makes parallelism a layout decision: every parameter
gets a PartitionSpec over the mesh (`partition_specs`: replicated by
default, the Megatron TP rules claim dims on `model`, and the FSDP
sweep shards the largest free dim divisible by the `fsdp` axis of every
leaf of at least `fsdp_min_size` elements). The port keeps those rules
as pure functions of names, shapes and the mesh's axis sizes:

  * `jax_view(name, shape, head_dim)` — a torch parameter as the JAX
    package holds it: its `/`-joined path, its flax shape (Linear
    weights [out, in] are kernels [in, out]; q/k/v [H*Dh, d] are
    [d, H, Dh], o_proj [d, H*Dh] is [H, Dh, d]; a ResNet conv weight
    [O, I, kh, kw] is the kernel [kh, kw, I, O], a BatchNorm weight its
    `scale`) and the torch dim of each flax dim (None for a head_dim
    merged into H*Dh);
  * `partition_specs(shapes, mesh)` — the JAX algorithm over flax
    paths and shapes, entry for entry;
  * `torch_layouts(named_shapes, head_dim, mesh)` — those specs as
    torch dims: which dim of each parameter `model` and `fsdp` split.

So the memory plan (`train/state.py` `plan_train_state`) and the CPU
tests need no process group. The appliers then lay a live model out:

  * `apply_tp`   — `parallelize_module` with a style per projection,
    its parameters distributed as the layouts say: column-parallel
    q/k/v, fc1, up/gate (output sharded over heads or features, kept
    local), lm_head and the token embedding (sharded, then gathered:
    the loss kernel sees whole logits); row-parallel o_proj, fc2, down
    (partial sums all-reduced). Every projection hands the next one a
    plain local tensor, so no DTensor reaches a kernel.
  * `apply_fsdp` — FSDP2 `fully_shard` per block, then the root, over
    the mesh's fsdp axis (HSDP when `data` > 1 as well), each
    parameter's shard dim from the layouts. Torch needs a non-zero
    shard dim to divide evenly; the JAX rule only picks divisible dims.
    Parameters the JAX rule leaves replicated (below `fsdp_min_size`,
    or with no divisible dim: LayerNorm scales, biases, the vocab-50257
    lm_head bias) stay out of FSDP (`ignored_params`) and are averaged
    by `GradSync` instead.
  * `apply_stacked` — the pipelined LM's stage leaves over `pipe` and
    the MoE experts over `expert` as DTensors split on their stacking
    dim (`stages/` and `experts/` claim dim 0 as in the reference; the
    TP rules anchor past the stacking dims).
  * `GradSync`   — the gradient all-reduces the step leaves to the
    trainer: DDP's over the batch axes, and the sums over the seq,
    pipe and expert ranks that share a loss.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np

from hyperion_tpu_torch.runtime.mesh import AxisName, axis_sizes

Rule = tuple[str, tuple]

# Megatron-style column/row split over the JAX paths and flax shapes:
# q/k/v column-parallel over heads, o_proj row-parallel, the MLP's up
# column-parallel and down row-parallel, lm_head and the embedding over
# their d/vocab columns (`:52-66` there).
TRANSFORMER_TP_RULES: tuple[Rule, ...] = (
    (r"(?:.*/)?(q_proj|k_proj|v_proj)/kernel$", (None, AxisName.MODEL, None)),
    (r"(?:.*/)?(q_proj|k_proj|v_proj)/bias$", (AxisName.MODEL, None)),
    (r"(?:.*/)?o_proj/kernel$", (AxisName.MODEL, None, None)),
    (r"(?:.*/)?(fc1|up_proj|gate_proj)/kernel$", (None, AxisName.MODEL)),
    (r"(?:.*/)?(fc1|up_proj|gate_proj)/bias$", (AxisName.MODEL,)),
    (r"(?:.*/)?(fc2|down_proj)/kernel$", (AxisName.MODEL, None)),
    (r"(?:.*/)?lm_head/kernel$", (None, AxisName.MODEL)),
    (r"(?:.*/)?(tok_emb|embed_tokens)/embedding$", (None, AxisName.MODEL)),
)

_HEADS_IN = ("q_proj", "k_proj", "v_proj")
COLUMN = ("q_proj", "k_proj", "v_proj", "fc1", "up_proj", "gate_proj")
ROW = ("o_proj", "fc2", "down_proj")
GATHERED = ("lm_head", "tok_emb")


def match_rule(path: str, rules: Sequence[Rule]) -> tuple | None:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return None


def _pad_spec(spec: tuple, rank: int) -> tuple:
    if len(spec) > rank:
        raise ValueError(f"spec {spec} longer than param rank {rank}")
    return tuple(spec) + (None,) * (rank - len(spec))


def _fsdp_augment(entries: tuple, shape: tuple, fsdp_size: int,
                  min_size: int, skip: tuple = ()) -> tuple:
    """Shard the largest still-unsharded dim divisible by the fsdp axis
    (ties: the later dim), never a dim in `skip`; leaves under
    `min_size` stay replicated (the reference's size-based auto-wrap
    policy)."""
    if fsdp_size == 1 or int(np.prod(shape)) < min_size:
        return entries
    candidates = [(dim, d) for d, (dim, e) in enumerate(zip(shape, entries))
                  if e is None and dim % fsdp_size == 0 and d not in skip]
    if not candidates:
        return entries
    _, best = max(candidates)
    out = list(entries)
    out[best] = AxisName.FSDP
    return tuple(out)


def _sizes(mesh) -> dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else axis_sizes(mesh)


def partition_specs(shapes: dict[str, tuple], mesh,
                    tp_rules: Sequence[Rule] | None = None,
                    fsdp: bool = True,
                    fsdp_min_size: int = 2**14) -> dict[str, tuple]:
    """{flax path: spec tuple} (trailing Nones dropped, `()` for
    replicated) for {flax path: flax shape}: every leaf replicated;
    `stages/` leaves ([S, lps, ...]) claim dim 0 on `pipe` when that
    axis is > 1 and `experts/` leaves ([E, ...]) dim 0 on `expert`,
    the TP rules then anchor on the dims past those (an indivisible
    claim raises); then the FSDP sweep when `fsdp` and the fsdp axis is
    > 1, never on a stage leaf's layer dim. `mesh`: a DeviceMesh, an
    AbstractMesh or a dict of axis sizes."""
    sizes = _sizes(mesh)
    tp_active = sizes.get(AxisName.MODEL, 1) > 1
    pipe_size = sizes.get(AxisName.PIPE, 1)
    expert_size = sizes.get(AxisName.EXPERT, 1)
    fsdp_size = sizes.get(AxisName.FSDP, 1) if fsdp else 1
    specs = {}
    for path, shape in shapes.items():
        shape = tuple(shape)
        lead: tuple = ()
        if pipe_size > 1 and re.match(r"(?:.*/)?stages/", path) and shape:
            if shape[0] != pipe_size:
                raise ValueError(
                    f"{path}: leading dim {shape[0]} != {pipe_size}-stage "
                    "pipe mesh axis (stages/ leaves must stack one slice "
                    "per pipeline stage)")
            lead = (AxisName.PIPE,) + ((None,) if len(shape) > 1 else ())
        elif expert_size > 1 and re.match(r"(?:.*/)?experts/", path) \
                and shape:
            if shape[0] % expert_size:
                raise ValueError(
                    f"{path}: {shape[0]} experts not divisible by the "
                    f"{expert_size}-way expert mesh axis")
            lead = (AxisName.EXPERT,)
        body = shape[len(lead):]
        entries = (None,) * len(body)
        if tp_active and tp_rules:
            rule = match_rule(path, tp_rules)
            if rule is not None:
                entries = _pad_spec(rule, len(body))
                bad = [(d, a) for d, a in enumerate(entries)
                       if a is not None and body[d] % sizes[a]]
                if bad:
                    raise ValueError(f"{path}: shape {shape} not divisible "
                                     f"by mesh axes {bad}")
        entries = lead + entries
        skip = (1,) if lead[:1] == (AxisName.PIPE,) else ()
        entries = _fsdp_augment(entries, shape, fsdp_size, fsdp_min_size,
                                skip)
        while entries and entries[-1] is None:
            entries = entries[:-1]
        specs[path] = entries
    return specs


@dataclasses.dataclass(frozen=True)
class JaxView:
    path: str          # the flax path, "/"-joined
    shape: tuple       # the flax shape
    dims: tuple        # torch dim of each flax dim (None: merged away)


def jax_view(name: str, shape: tuple, head_dim: int) -> JaxView:
    """A torch parameter of the port's TransformerLM, MoELM,
    PipelinedLM or Llama as the JAX package holds it (see the module
    docstring). A `stages.` leaf of the pipelined LM is one block's
    parameter stacked [S, lps, ...]: the block's view past those two
    dims."""
    if name.startswith("stages."):
        body = jax_view(name[len("stages."):], tuple(shape)[2:], head_dim)
        return JaxView("stages/" + body.path, tuple(shape)[:2] + body.shape,
                       (0, 1, *(None if d is None else d + 2
                                for d in body.dims)))
    parts = name.split(".")
    if parts[0] == "layers":                      # Llama's layers.i
        parts = [f"layer_{parts[1]}", *parts[2:]]
    if parts == ["embed_tokens"]:
        parts = ["embed_tokens", "embedding"]
    leaf, mod = parts[-1], (parts[-2] if len(parts) > 1 else "")
    shape = tuple(shape)
    if leaf == "weight" and len(shape) == 4:      # a conv [O, I, kh, kw]
        o, i, kh, kw = shape
        jshape, dims = (kh, kw, i, o), (2, 3, 1, 0)
        parts[-1] = "kernel"
    elif leaf == "weight" and len(shape) == 1 and "bn" in mod:
        jshape, dims = shape, (0,)                # BatchNorm scale
        parts[-1] = "scale"
    elif leaf == "weight" and len(shape) == 2:    # a projection
        out, inp = shape
        if mod in _HEADS_IN:
            jshape, dims = (inp, out // head_dim, head_dim), (1, 0, None)
        elif mod == "o_proj":
            jshape, dims = (inp // head_dim, head_dim, out), (1, None, 0)
        else:
            jshape, dims = (inp, out), (1, 0)
        parts[-1] = "kernel"
    elif leaf == "bias" and mod in _HEADS_IN:
        jshape, dims = (shape[0] // head_dim, head_dim), (0, None)
    else:
        jshape, dims = shape, tuple(range(len(shape)))
    return JaxView("/".join(parts), jshape, dims)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The torch dims of one parameter split over `model`, `fsdp`,
    `pipe` (a stage leaf's dim 0) and `expert` (an expert leaf's dim 0);
    None: not split over that axis."""

    model: int | None = None
    fsdp: int | None = None
    pipe: int | None = None
    expert: int | None = None

    @property
    def stacked(self) -> bool:
        """A stage or expert leaf split over its stacking dim: laid out
        by `apply_stacked`, not by the TP styles or FSDP2."""
        return self.pipe is not None or self.expert is not None


def torch_layouts(named_shapes: dict[str, tuple], head_dim: int, mesh,
                  tp_rules: Sequence[Rule] | None = TRANSFORMER_TP_RULES,
                  fsdp: bool = True, fsdp_min_size: int = 2**14
                  ) -> dict[str, Layout]:
    """{torch name: Layout} — `partition_specs` over each parameter's
    `jax_view`, mapped back to torch dims. A spec that splits a merged
    head_dim has no torch counterpart and raises."""
    views = {n: jax_view(n, s, head_dim) for n, s in named_shapes.items()}
    specs = partition_specs({v.path: v.shape for v in views.values()}, mesh,
                            tp_rules, fsdp, fsdp_min_size)
    out = {}
    for name, v in views.items():
        dims = {}
        for d, axis in enumerate(specs[v.path]):
            if axis is None:
                continue
            if v.dims[d] is None:
                raise ValueError(f"{name}: the JAX spec {specs[v.path]} of "
                                 f"{v.path} splits a head_dim the torch "
                                 "layout merges")
            dims[axis] = v.dims[d]
        out[name] = Layout(dims.get(AxisName.MODEL), dims.get(AxisName.FSDP),
                           dims.get(AxisName.PIPE), dims.get(AxisName.EXPERT))
    return out


def shardings_like(tree_shapes: dict[str, tuple],
                   param_shapes: dict[str, tuple],
                   param_specs: dict[str, tuple]) -> dict[str, tuple]:
    """Specs for leaves that mirror parameters (optimizer state): a leaf
    whose shape matches a parameter's takes that parameter's spec (the
    first such parameter's, as the JAX function maps by shape); every
    other leaf is replicated."""
    by_shape: dict[tuple, tuple] = {}
    for path, shape in param_shapes.items():
        by_shape.setdefault(tuple(shape), param_specs[path])
    return {k: by_shape.get(tuple(s), ()) for k, s in tree_shapes.items()}


# --- appliers --------------------------------------------------------


def model_layouts(model, mesh, fsdp: bool = True,
                  fsdp_min_size: int = 2**14) -> dict[str, Layout]:
    """`torch_layouts` of a live (or meta) model's parameters."""
    named = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return torch_layouts(named, getattr(model.cfg, "head_dim", 1), mesh,
                         TRANSFORMER_TP_RULES, fsdp, fsdp_min_size)


def _tp_style(kind: str, dims: dict[str, int | None]):
    """A ParallelStyle for one projection: its parameters distributed
    over the model axis as `dims` says (None: replicated), its input
    made a DTensor (replicated for a column split, sharded on the last
    dim for a row split) and its output returned as a plain tensor —
    gathered for `GATHERED` modules, summed for row splits, local
    otherwise."""
    from torch import nn
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_module,
        distribute_tensor,
    )
    from torch.distributed.tensor.parallel import ParallelStyle

    in_layout = Shard(-1) if kind == "row" else Replicate()

    class Style(ParallelStyle):
        def _apply(self, module, device_mesh):
            def partition(_, mod, mesh):
                for pname, p in list(mod.named_parameters(recurse=False)):
                    d = dims.get(pname)
                    placement = Replicate() if d is None else Shard(d)
                    mod.register_parameter(pname, nn.Parameter(
                        distribute_tensor(p.data, mesh, [placement]),
                        requires_grad=p.requires_grad))

            def inputs(mod, args, mesh):
                x = args[0]
                if not isinstance(x, DTensor):
                    x = DTensor.from_local(x, mesh, [in_layout],
                                           run_check=False)
                return (x, *args[1:])

            def outputs(mod, out, mesh):
                if kind != "column":
                    out = out.redistribute(mesh, [Replicate()])
                return out.to_local()

            return distribute_module(module, device_mesh, partition, inputs,
                                     outputs)

    return Style()


def apply_tp(model, mesh, layouts: dict[str, Layout]) -> None:
    """Tensor parallelism over the mesh's `model` axis (see the module
    docstring). Every module holding a model-split parameter must be a
    projection or an embedding the styles know; the one root parameter
    split over `model` is Llama's `embed_tokens`, a DTensor over its d
    columns that `models.llama.embed_lookup` reads. Stage and expert
    leaves are `apply_stacked`'s."""
    from torch import nn
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.parallel import parallelize_module

    by_module: dict[str, dict[str, int | None]] = {}
    for name, lay in layouts.items():
        if lay.stacked:
            continue
        mod, _, leaf = name.rpartition(".")
        by_module.setdefault(mod, {})[leaf] = lay.model
    tp = mesh[AxisName.MODEL]
    plan = {}
    for mod, dims in by_module.items():
        if all(d is None for d in dims.values()):
            continue
        kind = mod.rpartition(".")[2]
        if mod == "" and {k for k, d in dims.items() if d is not None} \
                == {"embed_tokens"}:
            p = model.embed_tokens
            model.embed_tokens = nn.Parameter(
                distribute_tensor(p.data, tp, [Shard(dims["embed_tokens"])]),
                requires_grad=p.requires_grad)
        elif kind in COLUMN:
            plan[mod] = _tp_style("column", dims)
        elif kind in ROW:
            plan[mod] = _tp_style("row", dims)
        elif kind in GATHERED:
            plan[mod] = _tp_style("gathered", dims)
        else:
            raise NotImplementedError(
                f"tensor parallelism of {mod or 'the root'!r} "
                f"({sorted(dims)}) is not ported")
    parallelize_module(model, tp, plan)


def apply_stacked(model, mesh, layouts: dict[str, Layout]) -> dict:
    """Lay out the stage leaves ([S, lps, ...], `stages.*`) and the
    expert leaves ([E, ...], `*.experts.*`) that their layouts split on
    `pipe` or `expert`: each becomes a DTensor over the submesh of the
    axes it is split on — its stacking dim over that axis, and a stage
    leaf also on the dims its layout gives `fsdp` and `model`, which the
    pipelined LM gathers inside the tick (`models/pipeline_lm.py`); an
    expert leaf stays whole over every other axis. Each rank keeps its
    own slice (no collective: every rank holds the same initial
    values). Returns {parameter: the axes it is split on}, for
    `GradSync`."""
    from torch import nn
    from torch.distributed.tensor import DTensor, Shard

    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = {}
    for name, lay in layouts.items():
        if not lay.stacked:
            continue
        dims = ({AxisName.PIPE: lay.pipe, AxisName.FSDP: lay.fsdp,
                 AxisName.MODEL: lay.model} if lay.pipe is not None
                else {AxisName.EXPERT: lay.expert})
        dims = {a: d for a, d in dims.items() if d is not None}
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        p = getattr(mod, leaf)
        local = p.data
        for a, d in dims.items():
            local = local.chunk(sizes[a], dim=d)[coord[a]]
        # over the submesh of its split axes (in the mesh's order): the
        # DTensor stays whole over every other axis
        names = tuple(a for a in mesh.mesh_dim_names if a in dims)
        new = nn.Parameter(DTensor.from_local(
            local.contiguous(), mesh[names], [Shard(dims[a]) for a in names],
            run_check=False), requires_grad=p.requires_grad)
        setattr(mod, leaf, new)
        out[new] = tuple(dims)
    return out


def data_parallel_mesh(mesh):
    """The mesh FSDP2 shards over: `fsdp`, or (`data`, `fsdp`) — HSDP,
    replicated over data — when the data axis is > 1 too."""
    if axis_sizes(mesh)[AxisName.DATA] > 1:
        return mesh[AxisName.DATA, AxisName.FSDP]
    return mesh[AxisName.FSDP]


def apply_fsdp(model, mesh, layouts: dict[str, Layout], blocks) -> list:
    """FSDP2 `fully_shard` on each of `blocks`, then on the root, over
    `data_parallel_mesh(mesh)`. Returns the parameters left out of FSDP
    (replicated by the layouts while the fsdp axis is > 1, and the
    stacked leaves `apply_stacked` laid out), in the model's parameter
    order (the same on every rank), whose gradients `GradSync` reduces.
    On a size-1 fsdp axis every other parameter is sharded (trivially),
    so FSDP2's collectives run at world 1 too."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dp = data_parallel_mesh(mesh)
    split = axis_sizes(mesh)[AxisName.FSDP] > 1

    def state():
        named = dict(model.named_parameters())
        ids = {id(p): n for n, p in named.items()}
        ignored = {p for n, p in named.items()
                   if layouts[n].stacked or split and layouts[n].fsdp is None}

        def place(p):
            d = layouts[ids[id(p)]].fsdp
            return Shard(0 if d is None else d)
        return ignored, place

    for block in blocks:
        ignored, place = state()
        fully_shard(block, mesh=dp, shard_placement_fn=place,
                    ignored_params=ignored or None)
    ignored, place = state()
    fully_shard(model, mesh=dp, shard_placement_fn=place,
                ignored_params=ignored or None)
    return [p for p in model.parameters() if p in ignored]


def local(t):
    """A DTensor's local shard (a view that writes through), or `t`."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


class GradSync:
    """The gradient reductions the step's backward leaves to the
    trainer: `entries` holds (parameter, groups, divisor) — each
    parameter's gradient is summed over `groups` (the replica axes it
    is not split on, `train/trainer.py` `_parallelize`) and divided by
    `divisor` (the replica count its loss share was scaled by), in one
    flat buffer per (groups, divisor, dtype). The DDP average over the
    batch axes is the case of every parameter over the data and fsdp
    groups, divided by their size. Entries must come in the same order
    on every rank. A parameter that requires a gradient and got none
    (a pipeline stage's unused embedding) gets zeros first, so every
    rank's buffers agree."""

    def __init__(self, entries: list[tuple]):
        self.entries = [(p, tuple(g), float(div)) for p, g, div in entries]

    def __call__(self) -> None:
        import torch
        import torch.distributed as tdist
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        buckets: dict = {}
        for p, groups, div in self.entries:
            if not groups and div == 1.0:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = local(p.grad)
            key = (tuple(id(x) for x in groups), div, g.dtype)
            buckets.setdefault(key, (groups, div, []))[2].append(g)
        for groups, div, grads in buckets.values():
            flat = _flatten_dense_tensors(grads)
            for group in groups:
                tdist.all_reduce(flat, group=group)
            if div != 1.0:
                flat.div_(div)
            with torch.no_grad():
                for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
                    g.copy_(s)
