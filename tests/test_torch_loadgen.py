"""The port's load generator (`hyperion_tpu_torch/serve/loadgen.py`) and
the analysis half of `obs/timeline.py` against the JAX package's.

`build_workload` must give the identical workload for the same spec —
arrivals, prompts, budgets, seeds, classes, tenants and ids — for every
shaping option; `run_load` must report exactly `SERVING_REPORT_KEYS`,
and its per-request temperature-0 streams on a tiny engine must equal
JAX `run_load`'s on the same weights. `run_load_socket` drives the
port's server over its unix socket.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from hyperion_tpu.obs import timeline as jtimeline
from hyperion_tpu.serve import loadgen as jload
from hyperion_tpu_torch.obs import timeline as ttimeline
from hyperion_tpu_torch.serve import loadgen as tload

SPECS = {
    "base": dict(n_requests=12, rate_hz=40.0, seed=3),
    "shared_prefix": dict(n_requests=10, shared_prefix_tokens=24, seed=4,
                          prompt_lens=(4, 8), deadline_s=5.0),
    "batch_every": dict(n_requests=10, batch_every=3, seed=5),
    "burst": dict(n_requests=12, adversary="burst", adversary_every=4,
                  seed=6),
    "slowloris": dict(n_requests=8, adversary="slowloris",
                      adversary_every=2, seed=7),
    "oversize": dict(n_requests=9, adversary="oversize", adversary_every=3,
                     seed=8),
    "rehit_churn": dict(n_requests=14, shared_prefix_tokens=16,
                        rehit_churn=4, seed=9),
}


def _view(arrivals, reqs):
    return (np.asarray(arrivals).tolist(),
            [(r.id, np.asarray(r.prompt_ids).tolist(), r.max_new_tokens,
              r.seed, r.temperature, r.deadline_s, r.sla_class, r.tenant)
             for r in reqs])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_build_workload_equals_the_reference(name):
    ref = _view(*jload.build_workload(jload.LoadSpec(**SPECS[name])))
    got = _view(*tload.build_workload(tload.LoadSpec(**SPECS[name])))
    assert got == ref
    assert len(got[1]) == SPECS[name]["n_requests"]


def test_report_vocabulary_equals_the_reference():
    assert tload.SERVING_REPORT_KEYS == jload.SERVING_REPORT_KEYS
    assert ttimeline.PHASES == jtimeline.PHASES
    assert tload.request_id(3, 7) == jload.request_id(3, 7)
    assert [f.name for f in tload.dataclasses.fields(tload.LoadSpec)] \
        == [f.name for f in jload.dataclasses.fields(jload.LoadSpec)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cohort_dominant_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 40
    values = rng.exponential(0.1, n).tolist()
    phases = [{p: float(rng.exponential(0.01)) for p in jtimeline.PHASES}
              for _ in range(n)]
    assert ttimeline.cohort_dominant(values, phases) \
        == jtimeline.cohort_dominant(values, phases)
    comps = phases[0]
    assert ttimeline.dominant_of(comps, 0.001) \
        == jtimeline.dominant_of(comps, 0.001)


@pytest.mark.parametrize("run", ["serve_r3_1754000000", "serve_1754000000",
                                 "route_1754000000", None])
def test_replica_tags_equal_the_reference(run):
    assert ttimeline.replica_of_run(run) == jtimeline.replica_of_run(run)
    rid = f"{run}~r2"
    assert ttimeline.base_request_id(rid) == jtimeline.base_request_id(rid)


LOAD = dict(n_requests=8, rate_hz=200.0, prompt_lens=(4, 8),
            max_new=(4, 6), vocab=500, shared_prefix_tokens=12,
            batch_every=3, seed=21)


@pytest.fixture(scope="module")
def loads():
    from test_torch_serve_socket import host_pair

    from hyperion_tpu.serve.engine import Engine as JEngine
    from hyperion_tpu.serve.engine import EngineConfig as JConfig
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig

    jmodel, variables, model = host_pair()
    jeng = JEngine(jmodel, variables, JConfig(slots=2, max_len=64,
                                              eos_id=None))
    jeng.warmup([32])
    teng = Engine(model, EngineConfig(slots=2, max_len=64, eos_id=None),
                  device="cpu")
    teng.warmup([32])
    out = {}
    for pkg, mod, eng in (("jax", jload, jeng), ("port", tload, teng)):
        streams = {}
        spec = mod.LoadSpec(**LOAD)
        _, reqs = mod.build_workload(spec)

        def keep(ev, _streams=streams):
            _streams.setdefault(ev.request.id, []).append(ev.token)

        eng.on_event = keep
        out[pkg] = (mod.run_load(eng, spec), streams)
    return out


def test_run_load_reports_exactly_the_serving_keys(loads):
    rep, _ = loads["port"]
    assert set(rep) == set(tload.SERVING_REPORT_KEYS)
    assert rep["completed"] == LOAD["n_requests"] and rep["rejected"] == 0
    assert rep["prefix_hit_rate"] > 0 and rep["recompiles"] == 0
    assert rep["batch_completed"] == 2 and rep["tokens_per_s"] > 0


def test_run_load_streams_equal_the_reference(loads):
    _, ref = loads["jax"]
    _, got = loads["port"]
    assert len(got) == LOAD["n_requests"]
    assert got == ref
    # the same counts where the report is deterministic
    keys = ("requests", "completed", "rejected", "tokens", "slots",
            "shared_prefix_tokens", "batch_completed",
            "interactive_completed")
    assert {k: loads["port"][0][k] for k in keys} \
        == {k: loads["jax"][0][k] for k in keys}


def test_run_load_socket_drives_the_port_server(tmp_path):
    from test_torch_serve_socket import host_pair

    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.server import serve_socket

    eng = Engine(host_pair()[2], EngineConfig(slots=2, max_len=64,
                                              eos_id=None), device="cpu")
    eng.warmup([32])
    sock = str(tmp_path / "lg.sock")
    stop, ready = threading.Event(), threading.Event()
    t = threading.Thread(target=serve_socket, args=(eng, sock),
                         kwargs={"should_stop": stop.is_set,
                                 "ready": ready}, daemon=True)
    t.start()
    assert ready.wait(timeout=30)
    try:
        rep = tload.run_load_socket(sock, tload.LoadSpec(**LOAD),
                                    request_timeout_s=60,
                                    session_every=2)
    finally:
        stop.set()
        t.join(timeout=30)
    assert rep["mode"] == "socket"
    assert rep["completed"] == LOAD["n_requests"] and rep["rejected"] == 0
    assert rep["duplicate_tokens"] == 0 and rep["tokens"] > 0
    assert rep["router_overhead_p99_ms"] is not None
