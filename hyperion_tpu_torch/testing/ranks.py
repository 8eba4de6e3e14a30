"""Run a function on a world of spawned gloo ranks — the multi-rank
harness of the port's CPU tests (and a quick way to try a sharded path
without torchrun).

    results = run_ranks(fn, 4, arg, timeout=120)

Each rank is a fresh interpreter (`spawn`) with one intra-op thread,
RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT set to free
local ports (the host coordinator on its own), joined by
`runtime/dist.py` `setup("cpu")`; it calls `fn(*args)` (a module-level
function: spawn imports it by name) and hands back the return value
through a file. `run_ranks` returns the values in rank order, and
raises when a rank fails (with its traceback) or when the world outlives
`timeout` — then every rank is killed, so a hung collective fails the
caller instead of hanging it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import socket
import tempfile
import time
import traceback
from pathlib import Path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, args, rank: int, world: int, env: dict, out: str) -> None:
    os.environ.update(env)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        import torch

        torch.set_num_threads(1)
        from hyperion_tpu_torch.runtime import dist

        dist.setup("cpu")
        try:
            result = ("ok", fn(*args))
        finally:
            dist.cleanup()
    except Exception:  # noqa: BLE001 — reported to the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    os._exit(0 if result[0] == "ok" else 1)


def run_ranks(fn, world: int, *args, timeout: float = 120.0,
              env: dict | None = None) -> list:
    """`fn(*args)` on each of `world` gloo ranks; their return values in
    rank order (see the module docstring)."""
    ctx = mp.get_context("spawn")
    base = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "HYPERION_COORD_PORT": str(free_port()), **(env or {})}
    with tempfile.TemporaryDirectory(prefix="hyperion-ranks-") as tmp:
        outs = [str(Path(tmp) / f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_child,
                             args=(fn, args, r, world, base, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout}s (killed)")
        results = []
        for r, out in enumerate(outs):
            if not os.path.exists(out):
                raise RuntimeError(f"rank {r} died (exit code "
                                   f"{procs[r].exitcode}) without a result")
            with open(out, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        return results
