"""The device mesh — `hyperion_tpu/runtime/mesh.py`, over torch's
`DeviceMesh`.

Axes, as in the JAX package:
  data   pure data parallelism (the reference's DDP)
  fsdp   parameter, gradient and optimizer-state sharding (FSDP
         FULL_SHARD); also shards the batch
  model  tensor parallelism (Megatron column/row splits)
  seq    sequence parallelism: each rank holds a slice of every row's
         positions; ring or Ulysses attention over the seq group
  pipe   pipeline parallelism: each rank is one GPipe stage
  expert expert parallelism: each rank holds n_experts / expert of the
         MoE experts, and tokens reach them by all-to-all

`make_mesh` lays the process group's ranks out over the six named axes
with `init_device_mesh` (rank = row-major coordinate, as `jax.make_mesh`
orders devices); `make_abstract_mesh` is a shape-only mesh for planning
(`--dry-init`) that needs no process group. `batch_rows` is the
counterpart of `batch_sharding`: the rows of a global batch that this
rank holds, split over (data, fsdp) in that order (the language jobs
split them over `expert` too, `LM_ROWS`: the tokens an expert rank
sends to the other experts are its own); `seq_cols` the positions of
each row a seq rank holds. `axis_groups` / `axes_size` / `axes_index`
read a set of axes (the step's reductions, `train/step.py` `BatchSync`),
and `seq_shard` is the active mesh's seq coordinate, from which the
models take global positions.
"""

from __future__ import annotations

import dataclasses
import math


class AxisName:
    DATA = "data"
    FSDP = "fsdp"
    MODEL = "model"
    SEQ = "seq"
    PIPE = "pipe"
    EXPERT = "expert"

    ALL = (DATA, FSDP, MODEL, SEQ, PIPE, EXPERT)
    # the batch is split over every data-like axis: fsdp consumes batch
    # too (FSDP is data-parallel in its activation flow)
    BATCH = (DATA, FSDP)
    # the axes a language job splits its batch rows over: an expert rank
    # routes its own tokens to every expert
    LM_ROWS = (DATA, FSDP, EXPERT)
    # the axes a language job's loss and gradients are reduced over:
    # every axis but `model`, whose ranks compute one loss together
    LM_REPLICAS = (DATA, FSDP, SEQ, PIPE, EXPERT)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``-1`` on exactly one axis means "infer from
    the device count"; every other axis must divide it."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = dataclasses.asdict(self)
        infer = [k for k, v in sizes.items() if v == -1]
        if len(infer) > 1:
            raise ValueError(f"at most one axis may be -1, got {infer}")
        bad = {k: v for k, v in sizes.items() if v != -1 and v < 1}
        if bad:
            raise ValueError(
                f"axis sizes must be >= 1 (or -1 to infer): {bad}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if infer:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes {sizes}")
            sizes[infer[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices, have {n_devices}")
        return MeshSpec(**sizes)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.model, self.seq, self.pipe,
                self.expert)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind them: what
    planning needs (`train/state.py` `plan_train_state`)."""

    spec: MeshSpec

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return AxisName.ALL

    @property
    def size(self) -> int:
        return math.prod(self.spec.shape)


def make_abstract_mesh(spec: MeshSpec) -> AbstractMesh:
    """Shape-only mesh for planning: no process group, no device, and
    axis sizes may exceed what this machine holds. Every axis must be
    explicit (there is no device count to infer ``-1`` from)."""
    if -1 in spec.shape:
        raise ValueError(
            f"abstract mesh needs explicit axis sizes (no -1): {spec}")
    return AbstractMesh(spec)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(AxisName.ALL, mesh.spec.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_mesh(spec: MeshSpec | None = None, device_type: str | None = None):
    """The global mesh over the process group's ranks; every axis is
    named, size-1 axes included. Defaults to all-data over the world,
    the reference's torchrun world of DDP ranks."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    if not tdist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(runtime/dist.py setup())")
    spec = (spec or MeshSpec()).resolve(tdist.get_world_size())
    if device_type is None:
        device_type = ("cuda" if tdist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, spec.shape,
                            mesh_dim_names=AxisName.ALL)


# --- active mesh: the training mesh, registered by the trainers -------

_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


class activate_mesh:
    """`with activate_mesh(mesh): ...` restores the previous active mesh
    on exit."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = active_mesh()
        set_active_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(self.prev)


def axes_size(mesh, axes=AxisName.BATCH) -> int:
    s = axis_sizes(mesh)
    return math.prod(s[a] for a in axes)


def axes_index(mesh, axes=AxisName.BATCH) -> int:
    """This rank's row-major coordinate over `axes` (in that order)."""
    s = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    i = 0
    for a in axes:
        i = i * s[a] + coord[a]
    return i


def axis_index(mesh, axis: str) -> int:
    return axes_index(mesh, (axis,))


def axis_groups(mesh, axes=AxisName.BATCH) -> list:
    """The process groups of those of `axes` larger than one, in order:
    a sum over them all is a sum over the ranks that differ on them."""
    s = axis_sizes(mesh)
    return [mesh.get_group(a) for a in axes if s[a] > 1]


def batch_rows(mesh, global_batch: int, axes=AxisName.BATCH) -> slice:
    """The rows of a [global_batch, ...] batch this rank holds, split
    over `axes`; ranks that differ only on another axis hold the same
    rows."""
    n = axes_size(mesh, axes)
    if global_batch % n:
        raise ValueError(f"global_batch {global_batch} not divisible by the "
                         f"mesh's {n} batch shards ({'*'.join(axes)} axes of "
                         f"{axis_sizes(mesh)})")
    local = global_batch // n
    i = axes_index(mesh, axes)
    return slice(i * local, (i + 1) * local)


def seq_cols(mesh, seq_len: int) -> slice:
    """The positions [i*T/n, (i+1)*T/n) of each row that this rank's seq
    coordinate i of n holds."""
    n = axis_sizes(mesh)[AxisName.SEQ]
    if seq_len % n:
        raise ValueError(f"seq_len {seq_len} not divisible by seq={n}")
    local = seq_len // n
    i = axis_index(mesh, AxisName.SEQ)
    return slice(i * local, (i + 1) * local)


def seq_shard() -> tuple[int, int]:
    """(index, size) of this rank on the active mesh's seq axis: (0, 1)
    without an active mesh or with seq 1. A model given positions
    [0, T) of a seq-sharded batch holds global positions
    [index*T, (index+1)*T)."""
    mesh = active_mesh()
    if mesh is None or isinstance(mesh, AbstractMesh):
        return 0, 1
    n = axis_sizes(mesh)[AxisName.SEQ]
    return (axis_index(mesh, AxisName.SEQ), n) if n > 1 else (0, 1)
