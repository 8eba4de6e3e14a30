"""Python face of the native host-coordination layer (`native/coord.cpp`)
— `hyperion_tpu/runtime/native_coord.py`.

It complements `runtime/dist.py`: torch's process group carries the
collectives; this layer gives the trainers what the reference leaned on
torchrun and NCCL's watchdog for — a pre-flight handshake with a hard
timeout (the `init_process_group(timeout=5min)` analogue), named
barriers that need no device (around checkpoint IO), and a dead peer
reported as an error instead of a hung collective.
"""

from __future__ import annotations

import ctypes
import os
import socket

from hyperion_tpu_torch.native import build

DEFAULT_PORT = 29501  # beside the reference's MASTER_PORT 29500


class CoordError(RuntimeError):
    pass


def _lib() -> ctypes.CDLL:
    lib = build.load("coord")
    lib.hypcoord_serve.restype = ctypes.c_void_p
    lib.hypcoord_serve.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hypcoord_connect.restype = ctypes.c_void_p
    lib.hypcoord_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hypcoord_barrier.restype = ctypes.c_int
    lib.hypcoord_barrier.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hypcoord_alive_count.restype = ctypes.c_int
    lib.hypcoord_alive_count.argtypes = [ctypes.c_void_p]
    lib.hypcoord_close.restype = None
    lib.hypcoord_close.argtypes = [ctypes.c_void_p]
    return lib


class HostCoordinator:
    """Rank 0 serves, everyone else connects; `barrier()` syncs all
    hosts or raises with a reason (timeout or dead peer)."""

    def __init__(self, rank: int, world: int, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT, timeout_s: float = 300.0):
        self.rank = rank
        self.world = world
        self._lib = _lib()
        ms = int(timeout_s * 1000)
        if rank == 0:
            self._handle = self._lib.hypcoord_serve(port, world, ms)
        else:
            # the C side takes a dotted address; torchrun's MASTER_ADDR
            # may be a name ("localhost")
            addr = socket.gethostbyname(host)
            self._handle = self._lib.hypcoord_connect(addr.encode(), port,
                                                      rank, ms)
        if not self._handle:
            raise CoordError(f"host rendezvous failed (rank {rank}/{world} "
                             f"@ {host}:{port})")

    def barrier(self, timeout_s: float = 60.0) -> None:
        rc = self._lib.hypcoord_barrier(self._handle, int(timeout_s * 1000))
        if rc == -2:
            raise CoordError(f"barrier timeout after {timeout_s}s "
                             f"(rank {self.rank})")
        if rc != 0:
            raise CoordError(f"barrier failed — peer died (rank {self.rank})")

    def alive_count(self) -> int:
        """The coordinator's count of live hosts (a worker knows only
        its own liveness and answers the world size)."""
        n = self._lib.hypcoord_alive_count(self._handle)
        return self.world if n < 0 else n

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hypcoord_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def from_env(timeout_s: float = 300.0) -> HostCoordinator | None:
    """Build from the launch environment (RANK / WORLD_SIZE /
    MASTER_ADDR, as torchrun sets them); None for a single process."""
    world = int(os.environ.get("WORLD_SIZE")
                or os.environ.get("NUM_PROCESSES") or 1)
    if world <= 1:
        return None
    rank = int(os.environ.get("RANK") or os.environ.get("PROCESS_ID") or 0)
    host = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = int(os.environ.get("HYPERION_COORD_PORT", DEFAULT_PORT))
    return HostCoordinator(rank, world, host, port, timeout_s)
