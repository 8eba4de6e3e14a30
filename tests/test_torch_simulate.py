"""The port's fleet flight simulator (`serve/simulate.py`) against the
JAX package's: each of the five scenarios, at the reference tests'
small size (4 replicas, 150 requests, 90 virtual s) and at its design
shape with a tenth of its requests, plays the port's policy objects
(`RouterPolicy`, `FleetActions`, `StreamDedup`, `AdmissionQueue`,
`BrownoutGovernor`, `ReplicaHandle`, `SLOMonitor`, `VirtualClock`) to
the reference's report, asserts and telemetry byte for byte; the port's
`obs doctor` and `obs diff` read that telemetry as the reference's do.
The seeded-regression demo (hysteresis off) fails the same assert in
both. The design-size soaks are marked slow, as the reference's are.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from hyperion_tpu.obs import diff as jdiff
from hyperion_tpu.obs import doctor as jdoctor
from hyperion_tpu.serve import simulate as jsim
from hyperion_tpu_torch.obs import diff, doctor
from hyperion_tpu_torch.obs.heartbeat import read_heartbeat
from hyperion_tpu_torch.serve import simulate

REPO = Path(__file__).resolve().parents[1]
SIZES = {"small": dict(replicas=4, requests=150, duration_s=90.0),
         "tenth": None}


def _scenario(mod, name: str, size: str) -> dict:
    scn = dict(mod.SCENARIOS[name])
    if SIZES[size] is None:
        scn["requests"] = scn["requests"] // 10
    else:
        scn.update(SIZES[size])
    return scn


def _diag(mod, out: Path, now: float) -> dict:
    d = mod.diagnose(out, now=now)
    return {k: v for k, v in d.items() if k not in ("target", "telemetry")}


def _play(name: str, size: str, tmp_path: Path, **kw) -> tuple:
    ours = simulate.run_scenario(_scenario(simulate, name, size),
                                 out=str(tmp_path / "port"), **kw)
    ref = jsim.run_scenario(_scenario(jsim, name, size),
                            out=str(tmp_path / "jax"), **kw)
    return ours, ref


def _held(ours: dict, ref: dict, tmp_path: Path) -> None:
    """The port's result, telemetry and heartbeat are the reference's;
    both doctors give the same diagnosis of both directories."""
    for k in ("report", "asserts", "ok", "requests", "replicas",
              "scenario", "virtual_s"):
        assert ours[k] == ref[k], k
    assert set(ours["report"]) == set(simulate.REPORT_KEYS)
    port, jax = tmp_path / "port", tmp_path / "jax"
    assert (port / "telemetry.jsonl").read_bytes() \
        == (jax / "telemetry.jsonl").read_bytes()
    hb, jhb = (read_heartbeat(p / "heartbeat.json") for p in (port, jax))
    for k in ("pid", "rss_mb"):  # the process's own, not the run's
        hb.pop(k), jhb.pop(k)
    assert hb == jhb
    now = hb["t_wall"] + 30.0
    want = _diag(jdoctor, jax, now)
    assert _diag(doctor, port, now) == _diag(doctor, jax, now) == want
    assert want["sim"]["ok"] is ref["ok"]
    assert want["verdict"] == "healthy"


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("name", sorted(jsim.SCENARIOS))
def test_scenario_equals_the_reference(name, size, tmp_path):
    ours, ref = _play(name, size, tmp_path)
    _held(ours, ref, tmp_path)


def test_seeded_regression_demo_fails_like_the_reference(tmp_path):
    """slow_burn with the steer hysteresis off (steer_clear_sweeps=1)
    flaps: the reversal bound fails in both packages, at one count."""
    ours, ref = _play("slow_burn", "tenth", tmp_path,
                      router={"steer_clear_sweeps": 1})
    _held(ours, ref, tmp_path)
    ours = simulate.run_scenario("slow_burn", out=str(tmp_path / "port"),
                                 router={"steer_clear_sweeps": 1})
    ref = jsim.run_scenario("slow_burn", out=str(tmp_path / "jax"),
                            router={"steer_clear_sweeps": 1})
    _held(ours, ref, tmp_path)
    assert not ours["ok"]
    failed = [a["key"] for a in ours["asserts"] if not a["ok"]]
    assert "steer_reversals" in failed
    assert ours["report"]["steer_reversals"] > 2


def test_dense_failover_never_duplicates_tokens(tmp_path):
    """900 requests on the small fleet put streams in flight on the
    killed half: the port's StreamDedup replays them with no duplicate
    token, as the reference's does."""
    ours, ref = _play("failover", "small", tmp_path, requests=900)
    _held(ours, ref, tmp_path)
    assert ours["report"]["duplicate_tokens"] == 0
    assert ours["report"]["redispatched"] >= 1


def test_seed_decides_the_traffic(tmp_path):
    a = simulate.run_scenario(_scenario(simulate, "failover", "small"),
                              out=str(tmp_path / "a"))
    b = simulate.run_scenario(_scenario(simulate, "failover", "small"),
                              out=str(tmp_path / "b"), seed=99)
    ref = jsim.run_scenario(_scenario(jsim, "failover", "small"),
                            out=str(tmp_path / "c"), seed=99)
    assert a["report"] != b["report"] == ref["report"]


def test_diff_reads_the_simulator_like_the_reference(tmp_path, capsys):
    """Two seeds of one scenario through `obs diff`: the same table and
    exit code; the bench row's fleet_sim keys normalize alike."""
    dirs = []
    for seed in (23, 99):
        out = tmp_path / str(seed)
        simulate.run_scenario(_scenario(simulate, "failover", "small"),
                              out=str(out), seed=seed)
        dirs.append(str(out))
    rc = diff.main(dirs)
    ours = capsys.readouterr()
    assert (rc, ours.out, ours.err) == (jdiff.main(dirs),
                                        *capsys.readouterr())
    assert simulate.DIFF_GATED == jsim.DIFF_GATED
    doc = {"metric": "synthetic", "value": 1.0,
           "fleet_sim": {simulate.diff_key(s, k): 1.0
                         for s, keys in simulate.DIFF_GATED.items()
                         for k in keys}}
    assert diff.normalize(doc) == jdiff.normalize(doc)
    for s, keys in simulate.DIFF_GATED.items():
        for k in keys:
            assert simulate.diff_key(s, k) in diff.normalize(doc)
            assert simulate.diff_key(s, k) in diff.METRICS


def test_scenario_library_is_the_references():
    assert simulate.SCENARIOS == jsim.SCENARIOS
    assert simulate.REPORT_KEYS == jsim.REPORT_KEYS
    for k in ("DEFAULT_FLEET", "DEFAULT_ROUTER", "DEFAULT_SLO", "WALL0",
              "MONO0"):
        assert getattr(simulate, k) == getattr(jsim, k), k


@pytest.mark.parametrize("argv", [
    ["--list"], [], ["nope"],
    ["failover", "--replicas", "4", "--requests", "150", "--duration-s",
     "90", "--json"],
    ["slow_burn", "--requests", "900", "--steer-clear-sweeps", "1",
     "--no-assert"]])
def test_cli_exits_like_the_reference(argv, tmp_path, capsys):
    def run(mod, out):
        rc = mod.main(argv + (["--out", str(out)] if argv[:1] not in
                              ([], ["--list"], ["nope"]) else []))
        got = capsys.readouterr()
        text = got.out.replace(str(out), "OUT")
        if "--json" in argv:
            res = json.loads(text)
            res.pop("wall_s")
            text = res
        else:
            text = re.sub(r"in \d+\.\d+s wall", "in -s wall", text)
        return rc, text, got.err

    assert run(simulate, tmp_path / "port") == run(jsim, tmp_path / "jax")


@pytest.mark.parametrize("rel", ["hyperion_tpu_torch/serve/queue.py",
                                 "hyperion_tpu_torch/serve/router.py",
                                 "hyperion_tpu_torch/serve/simulate.py"])
def test_policy_modules_read_time_only_through_the_clock(rel):
    """The simulator's virtual clock keeps its authority only while the
    policy code reads time through the injected clock."""
    hits = re.findall(r"time\.(?:monotonic|time)\(",
                      (REPO / rel).read_text())
    assert not hits, (rel, hits)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(jsim.SCENARIOS))
def test_design_size_scenario_equals_the_reference(name, tmp_path):
    ours = simulate.run_scenario(name, out=str(tmp_path / "port"))
    ref = jsim.run_scenario(name, out=str(tmp_path / "jax"))
    _held(ours, ref, tmp_path)
    assert ours["ok"], ours["asserts"]
