"""Collective-communication sanity check — `hyperion_tpu/runtime/
comm_check.py`, the reference's `test_nccl.py`.

The reference (`02_development/test_nccl.py:8-47`) inits an NCCL group,
all-reduces `ones(1) * rank`, checks `sum(range(world))` and exits 1 on
failure. Here every collective the sharded layouts rely on runs over the
world group on x[rank] = rank, each checked numerically on every rank:
all-reduce (sum and max: DDP's gradients, the clip norm, the step
agreement), all-gather and reduce-scatter (FSDP's parameters and
gradients) and the ring shift (send to rank + 1, receive from rank - 1).
At world 1 the ring shift is the identity and is reported so, with no
send.

    torchrun --nproc-per-node N -m hyperion_tpu_torch.runtime.comm_check
    python -m hyperion_tpu_torch.runtime.comm_check --device cpu   # gloo
    RANK=r WORLD_SIZE=n MASTER_ADDR=... python -m \\
        hyperion_tpu_torch.runtime.comm_check --host-only

`--host-only` exercises the C++ host coordinator alone (handshake,
named barriers, liveness) with no process group and no device: the
pre-flight before chips are committed to a job.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as tdist

from hyperion_tpu_torch.runtime import dist


def _checks(n: int, rank: int, dev) -> dict:
    """name → (fn, expected) on x = [rank] (fp32)."""

    def all_reduce(op):
        def fn(x):
            tdist.all_reduce(x, op=op)
            return x
        return fn

    def all_gather(x):
        out = torch.empty(n, dtype=x.dtype, device=dev)
        tdist.all_gather_into_tensor(out, x)
        return out

    def reduce_scatter(x):
        # each rank contributes n copies of its index; shard r holds the
        # sum over ranks, n(n-1)/2
        out = torch.empty(1, dtype=x.dtype, device=dev)
        tdist.reduce_scatter_tensor(out, x.repeat(n))
        return out

    def ring_shift(x):
        if n == 1:
            return x.clone()  # the identity: nothing to send
        out = torch.empty_like(x)
        ops = [tdist.P2POp(tdist.isend, x, (rank + 1) % n),
               tdist.P2POp(tdist.irecv, out, (rank - 1) % n)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return out

    total = float(sum(range(n)))
    return {
        "all_reduce_sum": (all_reduce(tdist.ReduceOp.SUM), [total]),
        "all_reduce_max": (all_reduce(tdist.ReduceOp.MAX), [float(n - 1)]),
        "all_gather": (all_gather, [float(i) for i in range(n)]),
        "reduce_scatter": (reduce_scatter, [total]),
        "ring_shift": (ring_shift, [float((rank - 1) % n)]),
    }


def comm_check(verbose: bool = True) -> dict:
    """Run every collective over the world group; {name: {"ok", "ms"}}
    for this rank. Needs `dist.setup()` first."""
    n, rank = tdist.get_world_size(), tdist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if tdist.get_backend() == "nccl" else torch.device("cpu"))
    results = {}
    for name, (fn, expected) in _checks(n, rank, dev).items():
        x = torch.tensor([float(rank)], device=dev)
        t0 = time.perf_counter()
        try:
            out = fn(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            got = out.cpu().tolist()
            good = got == expected
        except Exception as e:  # noqa: BLE001 — a failed collective is a result
            good, got = False, repr(e)
        ms = (time.perf_counter() - t0) * 1e3
        results[name] = {"ok": good, "ms": ms}
        if name == "ring_shift" and n == 1:
            results[name]["note"] = "identity at world 1"
        if verbose:
            status = "OK" if good else f"FAIL (got {got}, want {expected})"
            note = " (identity at world 1)" if n == 1 and \
                name == "ring_shift" else ""
            print(f"[comm_check] rank {rank}: {name:>15s} over {n} ranks: "
                  f"{status}{note} ({ms:.2f} ms)", flush=True)
    return results


def host_check(rounds: int = 3) -> bool:
    """The host layer alone: handshake (`dist.setup`), named barriers,
    liveness. A single process reports and passes."""
    os.environ.setdefault("HYPERION_SKIP_PG_INIT", "1")
    try:
        dist.setup()
        world = dist.process_count()
        if world <= 1:
            print("[comm_check] host-only: single process, nothing to sync")
            return True
        for i in range(rounds):
            dist.host_barrier(f"host_check_{i}", timeout_s=30.0)
        alive = dist.peers_alive()
        print(f"[comm_check] host-only rank {dist.process_index()}/{world}: "
              f"{rounds} barriers OK, {alive} hosts alive", flush=True)
        dist.cleanup()
        return alive == world
    except Exception as e:  # noqa: BLE001 — report, exit 1, like test_nccl
        print(f"[comm_check] host-only FAILED: {e}")
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host-only", action="store_true",
                   help="exercise only the C++ host coordinator (no "
                        "process group, no device)")
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL) or cpu (gloo)")
    args = p.parse_args(argv)
    if args.host_only:
        ok = host_check()
        print(f"[comm_check] {'HOST LAYER OK' if ok else 'FAILURE'}")
        return 0 if ok else 1
    if not dist.launched():  # a lone process is a world of one
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
    dist.setup(args.device)
    print(f"[comm_check] process {dist.process_index()}/"
          f"{dist.process_count()}, backend={tdist.get_backend()}",
          flush=True)
    ok = all(r["ok"] for r in comm_check().values())
    dist.cleanup()
    print(f"[comm_check] {'ALL COLLECTIVES PASSED' if ok else 'FAILURE'}")
    return 0 if ok else 1


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    sys.exit(main())
