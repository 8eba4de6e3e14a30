"""The port's distributed runtime against the JAX package's, on the CPU:
`MeshSpec.resolve` on a table of inputs, the single-process `setup`, the
collectives' check over gloo worlds of 1, 2 and 4, the step-boundary
agreement, and the C++ host coordinator (the port's own build of
`native/coord.cpp`), as tests/test_native.py and tests/test_runtime.py
hold the JAX package's: three-process barriers, the rendezvous timeout,
a dead peer failing fast, and the `--host-only` CLI's exit codes.
Every spawned process has its own timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from hyperion_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from hyperion_tpu_torch.runtime import dist
from hyperion_tpu_torch.runtime.mesh import MeshSpec
from hyperion_tpu_torch.runtime.native_coord import CoordError, HostCoordinator
from hyperion_tpu_torch.testing.ranks import free_port, run_ranks
from tests import torch_parallel_workers as W

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("spec, n", [
    (dict(), 8), (dict(data=2, fsdp=-1), 8), (dict(data=-1, model=2), 4),
    (dict(data=1, fsdp=2, model=2), 4), (dict(fsdp=4, data=-1), 8),
    (dict(data=3), 8), (dict(data=-1, fsdp=-1), 4), (dict(data=0), 1),
    (dict(data=2, fsdp=2), 8), (dict(data=-1, fsdp=3), 8)])
def test_mesh_spec_resolves_as_the_reference(spec, n):
    def resolve(cls):
        try:
            return ("ok", cls(**spec).resolve(n).shape)
        except ValueError as e:
            return ("error", str(e))

    assert resolve(MeshSpec) == resolve(JaxMeshSpec)


def test_single_process_setup_is_a_no_op(monkeypatch):
    for name in ("WORLD_SIZE", "NUM_PROCESSES", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert str(dist.setup("cpu")) == "cpu"
    assert not dist.is_distributed()
    assert (dist.process_index(), dist.process_count(),
            dist.is_primary(), dist.peers_alive()) == (0, 1, True, 1)
    assert dist.any_rank(True) and not dist.any_rank(False)
    dist.barrier("alone")
    dist.cleanup()


def test_comm_check_cli_at_world_1():
    proc = subprocess.run(
        [sys.executable, "-m", "hyperion_tpu_torch.runtime.comm_check",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ALL COLLECTIVES PASSED" in proc.stdout
    assert "identity at world 1" in proc.stdout


@pytest.mark.parametrize("world", [2, 4])
def test_comm_check_over_gloo(world):
    results = run_ranks(W.comm_check_run, world, timeout=120)
    assert len(results) == world
    for r in results:
        assert set(r) == {"all_reduce_sum", "all_reduce_max", "all_gather",
                          "reduce_scatter", "ring_shift"}
        assert all(v["ok"] for v in r.values()), r


def test_ranks_agree_at_a_step_boundary():
    """One rank's signal stops every rank; the coordinator counts three
    live hosts on the primary."""
    got = run_ranks(W.agree_run, 3, [False, True, False], timeout=120)
    assert [g[0] for g in got] == [True] * 3
    assert [g[1] for g in got] == [3] * 3
    assert got[0][2] == 3 and [g[3] for g in got] == [True, False, False]


class TestHostCoordinator:
    def test_three_process_barriers(self):
        port = free_port()
        ctx = mp.get_context("spawn")
        workers = [ctx.Process(target=W.coord_ok, args=(port, r, 3))
                   for r in (1, 2)]
        for w in workers:
            w.start()
        coord = HostCoordinator(0, 3, port=port, timeout_s=20)
        assert coord.alive_count() == 3
        for _ in range(3):
            coord.barrier(timeout_s=20)
        for w in workers:
            w.join(timeout=30)
            assert w.exitcode == 0
        coord.close()

    def test_rendezvous_timeout(self):
        t0 = time.monotonic()
        with pytest.raises(CoordError, match="rendezvous"):
            HostCoordinator(0, 3, port=free_port(), timeout_s=1.5)
        assert time.monotonic() - t0 < 10

    def test_dead_peer_fails_barrier_fast(self):
        port = free_port()
        ctx = mp.get_context("spawn")
        w1 = ctx.Process(target=W.coord_ok, args=(port, 1, 1))
        w2 = ctx.Process(target=W.coord_dies, args=(port, 2))
        w1.start()
        w2.start()
        coord = HostCoordinator(0, 3, port=port, timeout_s=20)
        w2.join(timeout=10)
        with pytest.raises(CoordError, match="died|timeout"):
            coord.barrier(timeout_s=8)
        w1.terminate()
        w1.join(timeout=5)
        coord.close()

    def test_build_lands_in_the_ports_own_tree(self):
        from hyperion_tpu_torch.native import build

        so = build.shared_object("coord")
        assert so.parent == REPO / "hyperion_tpu_torch" / "native" / "_build"
        assert (REPO / "hyperion_tpu") not in so.parents


_DIST_WORKER = r"""
import os
from hyperion_tpu_torch.runtime import dist
dist.setup()
assert dist.is_primary() == (os.environ["RANK"] == "0")
for i in range(3):
    dist.barrier(f"step_{i}")
alive = dist.peers_alive()
dist.cleanup()
print(f"WORKER_OK rank={os.environ['RANK']} alive={alive}")
"""

_DIES = r"""
import os
from hyperion_tpu_torch.runtime import dist
dist.setup()
os._exit(1)
"""

_SURVIVOR = r"""
import time
from hyperion_tpu_torch.runtime import dist
from hyperion_tpu_torch.runtime.native_coord import CoordError
dist.setup()
time.sleep(1.0)
try:
    dist.barrier("after_death")
    print("BARRIER_PASSED")
except CoordError as e:
    print(f"FAST_FAIL {e}")
"""


class TestHostCoordThroughDist:
    """The coordinator reached through `dist` (setup, barrier, cleanup)
    in host-only mode (`HYPERION_SKIP_PG_INIT=1`): no process group."""

    def _spawn(self, code: str, rank: int, port: int, *argv: str):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "HYPERION_COORD_PORT": str(port),
               "HYPERION_SKIP_PG_INIT": "1", "PYTHONPATH": str(REPO)}
        cmd = ([sys.executable, "-c", code] if code else
               [sys.executable, "-m", "hyperion_tpu_torch.runtime.comm_check",
                *argv])
        return subprocess.Popen(cmd, env=env, cwd=REPO, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def test_two_process_setup_and_barriers(self):
        port = free_port()
        procs = [self._spawn(_DIST_WORKER, r, port) for r in (0, 1)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
        assert "WORKER_OK rank=0 alive=2" in outs[0]
        assert "WORKER_OK rank=1" in outs[1]

    def test_peer_death_fails_fast(self):
        port = free_port()
        p0 = self._spawn(_SURVIVOR, 0, port)
        p1 = self._spawn(_DIES, 1, port)
        p1.communicate(timeout=60)
        out0 = p0.communicate(timeout=120)[0]
        assert "FAST_FAIL" in out0, out0

    def test_host_only_cli_exit_codes(self):
        """0 with both hosts up; 1 when the coordinator cannot listen
        (its port taken), without waiting out the rendezvous."""
        port = free_port()
        procs = [self._spawn("", r, port, "--host-only") for r in (0, 1)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
            assert "HOST LAYER OK" in out
        with socket.socket() as s:
            s.bind(("0.0.0.0", 0))
            s.listen(1)
            p = self._spawn("", 0, s.getsockname()[1], "--host-only")
            out = p.communicate(timeout=60)[0]
        assert p.returncode == 1, out
        assert "FAILURE" in out
