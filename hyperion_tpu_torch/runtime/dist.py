"""Process-group bootstrap — the `setup()`/`cleanup()` of
`hyperion_tpu/runtime/dist.py:62-253`, on torch's process groups.

The reference (`02_development/distributed_utils.py:96-125`) runs one
process per GPU under torchrun: `init_process_group("nccl",
init_method="env://", timeout=5min)` from RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT, then `torch.cuda.set_device(local_rank)`.
`setup(device)` does that here:

  * the backend is NCCL when the device is CUDA and gloo only when the
    caller asks for the CPU (`device="cpu"`); there is no fallback from
    one to the other;
  * a process launched without WORLD_SIZE is a single process, and
    `setup` is the no-op it is in the JAX package; under torchrun, even
    at `--nproc-per-node 1`, WORLD_SIZE is set and the group is made, so
    the sharded layouts run their collectives at world 1 too;
  * with more than one process the C++ host coordinator
    (`runtime/native_coord.py`) stands up first, as in the JAX `setup`:
    a pre-flight handshake with the same 5-minute timeout, named host
    barriers (`host_barrier`) and a dead peer turned into a `CoordError`
    (`peers_alive`). `HYPERION_HOST_COORD=0` turns it off, and
    `HYPERION_SKIP_PG_INIT=1` runs the host layer alone (the
    `--host-only` comm check, the JAX package's `HYPERION_SKIP_JAX_INIT`);
  * under NCCL a gloo group over the same ranks (`host_group`) carries
    what the host decides: `any_rank`, with which every rank agrees at a
    step boundary before any of them saves or stops, and `barrier`.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as tdist

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300  # the reference's process-group timeout

_INITIALIZED = False     # setup() made a process group or the host layer
_PG_SKIPPED = False      # host-coordination-only mode
_HOST_COORD = None
_HOST_RANK: int | None = None
_NUM_PROCESSES: int | None = None
_HOST_GROUP = None       # gloo group beside an NCCL default group
_DEVICE: torch.device | None = None

_ENV_RANK = ("RANK", "PROCESS_ID")
_ENV_WORLD = ("WORLD_SIZE", "NUM_PROCESSES")


def _env_first(names) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def launched() -> bool:
    """True when the launcher declared a world (torchrun sets
    WORLD_SIZE, at any size)."""
    return _env_first(_ENV_WORLD) is not None


def setup(device=None, num_processes: int | None = None,
          process_id: int | None = None,
          init_timeout_s: int = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group when this process was launched as a rank
    (WORLD_SIZE set, or `num_processes` given); safe to call more than
    once. Returns the device this rank runs on: `cuda:<LOCAL_RANK>`
    (None or "cuda"), or the CPU when `device` says so."""
    global _INITIALIZED, _PG_SKIPPED, _HOST_COORD, _HOST_RANK
    global _NUM_PROCESSES, _HOST_GROUP, _DEVICE
    from hyperion_tpu_torch import resolve_device

    if _INITIALIZED:
        return _DEVICE or resolve_device(device)
    if num_processes is None and not launched():
        return resolve_device(device)  # a single process: nothing to join
    world = num_processes or int(_env_first(_ENV_WORLD))
    rank = (process_id if process_id is not None
            else int(_env_first(_ENV_RANK) or 0))
    _NUM_PROCESSES = world
    address = os.environ.get("MASTER_ADDR")
    if (world > 1 and address and _HOST_COORD is None
            and os.environ.get("HYPERION_HOST_COORD", "1") != "0"):
        from hyperion_tpu_torch.runtime.native_coord import (
            DEFAULT_PORT,
            HostCoordinator,
        )

        port = int(os.environ.get("HYPERION_COORD_PORT", DEFAULT_PORT))
        _HOST_COORD = HostCoordinator(rank, world, address.split(":")[0],
                                      port, timeout_s=init_timeout_s)
        log.info("host coordinator up (rank %d/%d via %s)", rank, world,
                 address)
    if os.environ.get("HYPERION_SKIP_PG_INIT") == "1":
        _HOST_RANK, _PG_SKIPPED, _INITIALIZED = rank, True, True
        return resolve_device(device if device is not None else "cpu")

    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = resolve_device(f"cuda:{local}" if want.index is None
                             else want)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = want, "gloo"
    tdist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=init_timeout_s),
        **({"device_id": dev} if backend == "nccl" else {}))
    if backend == "nccl":
        _HOST_GROUP = tdist.new_group(backend="gloo")
    _DEVICE, _INITIALIZED = dev, True
    log.info("process group up: %s rank %d/%d on %s", backend, rank, world,
             dev)
    return dev


def cleanup() -> None:
    """Barrier, then tear down (the reference's `cleanup()`). The
    teardown runs even when the barrier raises on a dead peer."""
    global _INITIALIZED, _PG_SKIPPED, _HOST_COORD, _HOST_RANK
    global _HOST_GROUP, _DEVICE, _NUM_PROCESSES
    try:
        if _INITIALIZED:
            barrier("cleanup")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        if _HOST_COORD is not None:
            _HOST_COORD.close()
        _INITIALIZED = _PG_SKIPPED = False
        _HOST_COORD = _HOST_RANK = _HOST_GROUP = _DEVICE = None
        _NUM_PROCESSES = None


def is_distributed() -> bool:
    """True when a process group is up (at any world size)."""
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    if _HOST_RANK is not None:
        return _HOST_RANK
    return tdist.get_rank() if is_distributed() else 0


def process_count() -> int:
    if _PG_SKIPPED:
        return _NUM_PROCESSES or 1
    return tdist.get_world_size() if is_distributed() else 1


def is_primary() -> bool:
    """The process that owns the CSV, telemetry, heartbeat and commit
    duties — the reference's rank 0."""
    return process_index() == 0


def host_group():
    """The group that carries host decisions: the gloo group beside an
    NCCL default group, else the default group (None)."""
    return _HOST_GROUP


def host_barrier(name: str = "host", timeout_s: float = 60.0) -> None:
    """Named barrier through the C++ coordinator: no device work, and a
    dead peer raises `CoordError` instead of hanging."""
    if _HOST_COORD is not None:
        log.debug("host_barrier %s", name)
        _HOST_COORD.barrier(timeout_s)


def peers_alive() -> int:
    """The coordinator's count of live hosts; `process_count()` when the
    host layer is off."""
    if _HOST_COORD is not None:
        return _HOST_COORD.alive_count()
    return process_count()


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point: the host barrier first (fail fast on a
    dead peer), then the device's queued work and a barrier on the host
    group. On a single process it waits for the device."""
    host_barrier(name)
    if _PG_SKIPPED:
        return
    if _DEVICE is not None and _DEVICE.type == "cuda":
        torch.cuda.synchronize(_DEVICE)
    if is_distributed():
        tdist.barrier(group=host_group())


def host_sync(name: str = "host_sync") -> None:
    """Every rank reaches this point before any leaves it: the host
    barrier, then a barrier on the host group. No device work is waited
    for (a checkpoint's stage and commit points)."""
    host_barrier(name)
    if is_distributed() and process_count() > 1:
        tdist.barrier(group=host_group())


def broadcast(obj, src: int = 0):
    """`obj` as rank `src` has it, on every rank (host group)."""
    if not is_distributed() or process_count() == 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=src, group=host_group())
    return box[0]


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is True on any: how the ranks
    agree at a step boundary (a preemption signal, a health abort)
    before any of them saves or stops. A host-side all-reduce; on a
    single process it returns `flag`."""
    if not is_distributed() or process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=host_group())
    return bool(t.item())
