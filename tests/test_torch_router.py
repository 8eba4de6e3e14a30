"""The port's replica tier — `ReplicaHandle`, the router's dispatch
policy, its alert steering and scaling, `StreamDedup`, `RouterMetrics`
and the router WAL — against the JAX package's, and one fleet drill of
port replicas on the CPU.

The policy cases drive both packages through the same scripted
heartbeats, dispatches, ejections and alert sweeps and compare every
decision; they are cases of one parametrised test. The drill runs
`python -m hyperion_tpu_torch.cli.main route` over two port replicas
(`--device cpu`, fp32), one crashed mid-stream by chaos: every stream
completes exactly once and equals JAX `generate`, and the port's `obs
doctor`, `obs trace --fleet` and `obs top` read the router directory as
the reference's do, the fleet attribution's components summing
exactly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from hyperion_tpu.serve import hostcache as jhostcache
from hyperion_tpu.serve import metrics as jmetrics
from hyperion_tpu.serve import queue as jqueue
from hyperion_tpu.serve import replica as jreplica
from hyperion_tpu.serve import router as jrouter
from hyperion_tpu.serve import router_journal as jwal
from hyperion_tpu.serve import server as jserver
from hyperion_tpu_torch.serve import hostcache as thostcache
from hyperion_tpu_torch.serve import metrics as tmetrics
from hyperion_tpu_torch.serve import queue as tqueue
from hyperion_tpu_torch.serve import replica as treplica
from hyperion_tpu_torch.serve import router as trouter
from hyperion_tpu_torch.serve import router_journal as twal
from hyperion_tpu_torch.serve import server as tserver

REPO = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": types.SimpleNamespace(replica=jreplica, router=jrouter,
                                 metrics=jmetrics, queue=jqueue,
                                 hostcache=jhostcache),
    "port": types.SimpleNamespace(replica=treplica, router=trouter,
                                  metrics=tmetrics, queue=tqueue,
                                  hostcache=thostcache),
}


def beat(t, phase="serve", active=0, queue=0, pid=1, alerts=(),
         roots=None):
    hb = {"v": 1, "run": "x", "pid": pid, "phase": phase, "t_wall": t,
          "t_mono": t, "beats": 1, "active": active, "queue": queue,
          "alerts": list(alerts)}
    if roots is not None:
        hb["prefix_roots"] = list(roots)
    return hb


class _Events:
    """A tracer that keeps the events the policy emits."""

    run = "test"

    def __init__(self, log):
        self.log = log

    def event(self, name, **kw):
        self.log.append(("event", name, sorted(kw.items())))


class _Fleet:
    """One package's replicas and policy, with every decision logged."""

    def __init__(self, ns, base: Path, n=3, **kw):
        self.ns = ns
        self.reps = [ns.replica.ReplicaHandle.under(base, i)
                     for i in range(n)]
        self.pol = ns.router.RouterPolicy(self.reps, **kw)
        self.log: list = []
        self.hbs: dict = {}

    def beats(self, now, stale_s=10.0, **by_index):
        for i, hb in by_index.items():
            self.hbs[self.reps[int(i[1:])].heartbeat_path] = hb
        trs = self.pol.observe_beats(self.hbs.get, now=now, stale_s=stale_s)
        self.log.append(("beats", [(t[0], t[1].index, *t[2:])
                                   for t in trs]))

    def choose(self, doc, exclude=frozenset(), release=True):
        rep, meta = self.pol.choose(doc, exclude=exclude)
        self.log.append(("choose", None if rep is None else rep.index,
                         sorted(meta.items()),
                         [r.load_score() for r in self.reps]))
        if rep is not None and release:
            self.pol.release(rep)
        return rep

    def state(self):
        self.log.append(("state", [(r.state, r.eject_reason, r.steered,
                                    r.steer_clear_sweeps, r.ejected_at)
                                   for r in self.reps]))


def _all_ready(f, t=1.0, **kw):
    f.beats(t, **{f"r{i}": beat(t, **kw) for i in range(len(f.reps))})


def s_least_loaded(f):
    f.beats(1.0, r0=beat(1.0, active=2), r1=beat(1.0, queue=1),
            r2=beat(1.0))
    for _ in range(5):
        f.choose({"prompt_ids": [1, 2]}, release=False)
    f.beats(2.0, r0=beat(2.0), r1=beat(2.0, active=1), r2=beat(2.0))
    f.choose({"prompt_ids": [1, 2]})


def s_session_affinity(f):
    _all_ready(f)
    for sid in ("a", "b", "a", "c", "a", "b"):
        f.choose({"session_id": sid, "prompt_ids": [1]}, release=False)


def s_prefix_affinity(f):
    _all_ready(f)
    long = list(range(1, 41))
    f.choose({"prompt_ids": long}, release=False)
    f.choose({"prompt_ids": long[:32] + [99] * 8}, release=False)
    f.choose({"prompt_ids": long[:31]}, release=False)
    f.choose({"prompt": "x" * 130}, release=False)
    f.choose({"prompt": "x" * 128 + "yy"}, release=False)
    f.choose({"prompt": "short"})


def s_affinity_yields_past_slack(f):
    _all_ready(f)
    f.choose({"session_id": "hot"}, release=False)
    f.beats(2.0, r0=beat(2.0, active=3), r1=beat(2.0), r2=beat(2.0))
    f.choose({"session_id": "hot"})
    f.beats(3.0, r0=beat(3.0, active=6), r1=beat(3.0), r2=beat(3.0))
    f.choose({"session_id": "hot"})


def s_eject_and_readmit(f):
    _all_ready(f)
    f.beats(12.0, r0=beat(12.0), r1=beat(1.0), r2=beat(12.0, phase="drain"))
    f.state()
    f.choose({"prompt_ids": [3]})
    f.beats(13.0, r1=beat(5.0))        # newer than the file, older than
    f.state()                          # the ejection: stays out
    f.beats(14.0, r1=beat(14.0), r2=beat(14.0))
    f.state()
    f.log.append(("eject", f.pol.eject(f.reps[0], "connection error",
                                       now=15.0)))
    f.log.append(("eject", f.pol.eject(f.reps[0], "child exit 70",
                                       now=16.0)))
    f.state()
    f.choose({"prompt_ids": [3]}, exclude={1})
    f.choose({"prompt_ids": [3]}, exclude={1, 2})
    f.log.append(("ready", f.pol.ready_count, f.pol.inflight_total))


def s_cache_aware(f):
    ids = list(range(7, 90))
    digest = f.ns.hostcache.prefix_root_digest(ids)
    f.beats(1.0, r0=beat(1.0), r1=beat(1.0, active=2, roots=[digest]),
            r2=beat(1.0))
    f.choose({"prompt_ids": ids})
    f.choose({"prompt_ids": ids}, release=False)
    f.beats(2.0, r0=beat(2.0), r1=beat(2.0, active=9, roots=[digest]),
            r2=beat(2.0))
    f.choose({"prompt_ids": [5, 6] + ids})
    f.beats(3.0, r0=beat(3.0), r1=beat(3.0, roots=[]), r2=beat(3.0))
    f.choose({"prompt_ids": ids, "session_id": "s"})


def s_cache_aware_off(f):
    ids = list(range(7, 90))
    digest = f.ns.hostcache.prefix_root_digest(ids)
    f.pol.cache_aware = False
    f.beats(1.0, r0=beat(1.0), r1=beat(1.0, active=1, roots=[digest]),
            r2=beat(1.0))
    f.choose({"prompt_ids": ids})


def s_steer_and_scale(f):
    ups, downs, orders = [], [], []
    metrics = f.ns.metrics.RouterMetrics()
    acts = f.ns.router.FleetActions(
        f.pol, metrics, _Events(f.log), steer_clear_sweeps=2,
        scale_gov=f.ns.queue.BrownoutGovernor(depth_high=1),
        order_brownout=lambda rep, on: orders.append((rep.index, on)),
        scale_up=lambda: ups.append(1), scale_down=lambda: downs.append(1))
    _all_ready(f)
    for t, alerts in ((2.0, {"r0": ["ttft_p99"]}),
                      (3.0, {"r0": ["ttft_p99"], "r2": ["reject_rate"]}),
                      (4.0, {}), (5.0, {"r0": ["ttft_p99"]}), (6.0, {}),
                      (7.0, {}), (8.0, {})):
        f.beats(t, **{f"r{i}": beat(t, alerts=alerts.get(f"r{i}", ()))
                      for i in range(3)})
        f.log.append(("alerts", acts.sweep_alerts()))
        f.log.append(("burning", acts.sweep()))
        f.state()
        f.choose({"prompt_ids": [1]})
        f.choose({"prompt_ids": [1], "class": "batch"})
    f.log.append(("actions", orders, len(ups), len(downs)))
    summ = metrics.summary()
    f.log.append(("metrics", {k: summ[k] for k in sorted(summ)
                              if "steer" in k or "scale" in k
                              or "alert" in k or "brownout" in k}))


def s_ejected_silence_is_not_recovery(f):
    acts = f.ns.router.FleetActions(f.pol, f.ns.metrics.RouterMetrics(),
                                    _Events(f.log), steer_clear_sweeps=1)
    _all_ready(f, alerts=["ttft_p99"])
    acts.sweep()
    f.beats(30.0, r1=beat(30.0), r2=beat(30.0))
    for _ in range(3):
        acts.sweep()
    f.state()
    f.choose({"prompt_ids": [1]})


def s_affinity_lru(f):
    f.pol.affinity_cap = 2
    _all_ready(f)
    for sid in ("a", "b", "c", "a"):
        f.choose({"session_id": sid})
    f.log.append(("keys", list(f.pol._affinity)))


SCENARIOS = {fn.__name__[2:]: fn for fn in (
    s_least_loaded, s_session_affinity, s_prefix_affinity,
    s_affinity_yields_past_slack, s_eject_and_readmit, s_cache_aware,
    s_cache_aware_off, s_steer_and_scale,
    s_ejected_silence_is_not_recovery, s_affinity_lru)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_equal_the_reference(tmp_path, name):
    logs = {}
    for pkg, ns in PKGS.items():
        f = _Fleet(ns, tmp_path / pkg)
        SCENARIOS[name](f)
        logs[pkg] = f.log
    assert logs["port"] == logs["jax"]
    assert any(e[0] == "choose" for e in logs["port"])


@pytest.mark.parametrize("name", ["dedup", "replica_score", "route_slo",
                                  "router_metrics"])
def test_helpers_equal_the_reference(tmp_path, name):
    out = {}
    for pkg, ns in PKGS.items():
        if name == "dedup":
            d = ns.router.StreamDedup()
            seq = [{"event": "token", "i": i} for i in (0, 1, 2, 0, 1, 2, 3)]
            seq += [{"event": "token"}, {"event": "done"},
                    {"event": "token", "i": 1}]
            out[pkg] = [d.admit(r) for r in seq] + [d.delivered]
        elif name == "replica_score":
            rep = ns.replica.ReplicaHandle.under(tmp_path / pkg, 0)
            res = [rep.observe_beat(beat(1.0, active=2, queue=3), 1.0),
                   rep.load_score()]
            rep.dispatched_since_beat += 4
            res += [rep.load_score(),
                    rep.observe_beat(beat(2.0, active=4, queue=1), 2.0),
                    rep.load_score(), rep.check_stale(20.0, 5.0),
                    rep.state, Path(rep.socket_path).name,
                    Path(rep.journal_path).name,
                    Path(rep.telemetry_path).relative_to(tmp_path / pkg)]
            out[pkg] = res
        elif name == "route_slo":
            m = ns.metrics.RouterMetrics()
            for _ in range(3):
                m.on_complete()
            m.on_reject(ns.queue.REJECT_NO_REPLICA)
            out[pkg] = ns.router._route_window_value(
                m.reg, "reject_rate", 60.0)
        else:
            m = ns.metrics.RouterMetrics()
            for i, (aff, key) in enumerate(((True, True), (False, True),
                                            (False, False))):
                m.on_dispatch(i % 2, aff, key, cache_hit=i == 2)
            m.on_redispatch("replica_lost")
            m.on_failover_gap(0.25)
            m.on_failover_gap(1.5)
            m.on_complete()
            m.on_reject(ns.queue.REJECT_QUEUE_FULL)
            m.on_eject()
            m.on_readmit()
            m.on_adopt()
            m.on_resume()
            m.on_orphans(2)
            m.on_fleet_alerts(1)
            m.observe_fleet(2, 1, alerts_active=1)
            s = m.summary()
            out[pkg] = {k: s[k] for k in sorted(s)}
    assert out["port"] == out["jax"]
    if name == "router_metrics":
        s = out["port"]
        assert s["redispatched"] == 1 and s["adopted"] == 1
        assert s["orphans_recovered"] == 2
        assert s["failover_gap_p99_ms"] is not None


def test_router_flags_are_the_reference_s_plus_device_and_dtype():
    ref = {a.dest: a.default for a in jrouter.build_parser()._actions}
    got = {a.dest: a.default for a in trouter.build_parser()._actions}
    assert set(got) - set(ref) == {"device", "dtype"}
    assert {k: got[k] for k in ref} == ref
    assert (got["device"], got["dtype"]) == ("cuda", "bfloat16")


def test_replica_argv_parses_against_the_port_server(tmp_path):
    args = trouter.build_parser().parse_args(
        ["--ckpt", "m.npz", "--replicas", "2", "--device", "cpu",
         "--dtype", "float32", "--tokenizer-dir", "tok",
         "--host-cache-mb", "64", "--slo-ttft-p99-ms", "500",
         "--replica-chaos", "1:crash@tick=3"])
    rep = treplica.ReplicaHandle.under(tmp_path, 1)
    argv = trouter.replica_argv(args, rep)
    assert argv[1:4] == ["-m", "hyperion_tpu_torch.cli.main", "serve"]
    sargs = tserver.build_parser().parse_args(argv[4:])
    assert (sargs.device, sargs.dtype, sargs.chaos) \
        == ("cpu", "float32", "crash@tick=3")
    assert (sargs.socket, sargs.tokenizer_dir, sargs.host_cache_mb) \
        == (rep.socket_path, "tok", 64)
    # the rest of the command is the reference's, flag for flag
    ref = jrouter.replica_argv(args, rep)
    assert [x for x in argv[4:] if x not in ("--device", "cpu", "--dtype",
                                             "float32")] == ref[4:]
    assert jserver.build_parser().parse_args(ref[4:]).socket \
        == rep.socket_path


# ------------------------------------------------------------ the WAL


def _write_wal(mod, path):
    j = mod.RouterJournal(str(path))
    line = json.dumps({"id": "a", "prompt_ids": [1, 2], "seed": 3},
                      separators=(",", ":"))
    j.dispatch("a", line=line, replica=0, session="s:x", n=0,
               trace={"id": "a", "hop": 0, "attempt": 0, "router_life": 0})
    j.hwm("a", 1)
    j.dispatch("b", line='{"id":"b","prompt_ids":[4]}', replica=1,
               session=None)
    j.hwm("a", 2)
    j.dispatch("a", line=line, replica=1, session="s:x", n=1)
    j.hwm("a", 3)
    j.dispatch("c", line='{"id":"c","prompt":"hi"}', replica=0,
               session=None)
    j.done("c", "done")
    j.hwm("b", 1)
    j.close()


def _orphans(mod, path):
    orphans, clean = mod.RouterJournal(str(path)).recover()
    return clean, [(o.id, o.line, o.replica, o.session, o.hwm, o.dispatches,
                    o.doc) for o in orphans]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_recovers_the_same_orphans(tmp_path, writer):
    mods = {"jax": jwal, "port": twal}
    ref_path, path = tmp_path / "ref.jsonl", tmp_path / "wal.jsonl"
    _write_wal(jwal, ref_path)
    _write_wal(mods[writer], path)
    assert path.read_bytes() == ref_path.read_bytes()
    got = {pkg: _orphans(m, path) for pkg, m in mods.items()}
    assert got["port"] == got["jax"]
    clean, orphans = got["port"]
    assert not clean
    assert [(o[0], o[4], o[5]) for o in orphans] == [("a", 3, 2),
                                                     ("b", 1, 1)]


def test_wal_clean_close_recovers_nothing(tmp_path):
    j = twal.RouterJournal(str(tmp_path / "w.jsonl"))
    j.dispatch("a", line='{"id":"a"}', replica=0, session=None)
    j.done("a", "done")
    j.close_clean()
    assert _orphans(twal, tmp_path / "w.jsonl") \
        == _orphans(jwal, tmp_path / "w.jsonl") == (True, [])


def test_router_process_imports_no_torch():
    code = ("import sys, hyperion_tpu_torch.cli.main, "
            "hyperion_tpu_torch.serve.router, hyperion_tpu_torch.serve.client;"
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------ the fleet drill


def test_fleet_drill_exactly_once_equal_to_jax(tmp_path):
    """Two port replicas behind the port's router on the CPU, replica 0
    crashed at its second tick: every request done exactly once,
    indices 0..n-1, greedy and text streams equal to JAX `generate`, the
    sampled one equal to an uninterrupted port engine; the router
    re-dispatched; the port's doctor, fleet trace and top read the
    directory as the reference's do."""
    from test_torch_serve_socket import (
        _jax_generate,
        export_npz,
        port_engine_stream,
        save_tokenizer,
    )

    from hyperion_tpu.data.bpe import ByteBPE
    from hyperion_tpu.obs import doctor as jdoctor
    from hyperion_tpu.obs import fleet_trace as jfleet_trace
    from hyperion_tpu.obs import timeline as jtimeline
    from hyperion_tpu.obs import top as jtop
    from hyperion_tpu_torch.obs import doctor, fleet_trace, timeline, top

    ckpt = export_npz(tmp_path / "tiny.npz")
    tok_dir = save_tokenizer(tmp_path / "tok")
    budget = 10
    reqs = [{"id": f"a{i}", "prompt_ids": [3 + i, 4, 5, 6, 7, 8],
             "max_new_tokens": budget} for i in range(4)]
    reqs[1]["session_id"] = reqs[2]["session_id"] = "sess"
    reqs.append({"id": "txt", "prompt": "the model serves tokens",
                 "max_new_tokens": budget})
    reqs.append({"id": "smp", "prompt_ids": [9, 8, 7, 6, 5],
                 "max_new_tokens": budget, "temperature": 0.8,
                 "top_p": 0.9, "seed": 5})
    base = tmp_path / "fleet"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("HYPERION_TELEMETRY", None)
    env.pop("HYPERION_ATTEMPT", None)
    # --min-ready 2: dispatch spreads over both replicas before the
    # crash; the stdin tail keeps EOF from racing it
    r = subprocess.run(
        ["bash", "-c",
         f"(cat; sleep 2) | {sys.executable} -m hyperion_tpu_torch.cli.main"
         f" route --replicas 2 --min-ready 2 --ckpt {ckpt} --tokenizer-dir"
         f" {tok_dir} --base-dir {base} --device cpu --dtype float32"
         " --max-len 64 --slots 2 --warmup-lens 16"
         " --replica-heartbeat-every 1 --replica-chaos 0:crash@tick=2"],
        input="".join(json.dumps(x) + "\n" for x in reqs), env=env,
        capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    toks: dict = {}
    dones: dict = {}
    for line in r.stdout.splitlines():
        rec = json.loads(line)  # the router's stdout is the wire only
        if rec.get("event") == "token":
            toks.setdefault(rec["id"], []).append((rec["i"], rec["token"]))
        elif rec.get("event") == "done":
            dones[rec["id"]] = dones.get(rec["id"], 0) + 1
    assert dones == {x["id"]: 1 for x in reqs}
    tok = ByteBPE.load(tok_dir)
    for x in reqs:
        got = toks[x["id"]]
        assert [i for i, _ in got] == list(range(budget)), x["id"]
        if "temperature" in x:
            ref = port_engine_stream(x)
        else:
            ids = x.get("prompt_ids") or tok.encode(x["prompt"])
            ref = _jax_generate(np.asarray(ids, np.int32), budget)
        assert [t for _, t in got] == ref, x["id"]
    assert "crash@tick" in r.stderr
    records = [json.loads(x) for x in
               (base / "telemetry.jsonl").read_text().splitlines()]
    (end,) = [x for x in records if x.get("name") == "router_end"]
    assert end["redispatched"] >= 1 and end["completed"] == len(reqs)
    assert end["failover_gap_p99_ms"] is not None
    # the port's tools read the port's fleet directory as the
    # reference's do, at one frozen clock
    now = json.loads((base / "heartbeat.json").read_text())["t_wall"] + 5
    d = doctor.diagnose(base, now=now)
    assert d == jdoctor.diagnose(base, now=now)
    assert {row["replica"] for row in d["fleet"]} == {"0", "1"}
    assert d["verdict"] == "healthy"
    asm = fleet_trace.assemble(base)
    assert {q["id"] for q in asm["requests"]} >= {x["id"] for x in reqs}
    att = fleet_trace.attribution(asm)
    assert json.dumps(att, sort_keys=True) == json.dumps(
        jfleet_trace.attribution(jfleet_trace.assemble(base)),
        sort_keys=True)
    assert att["rows"]
    for row in att["rows"]:
        total = sum(row["components_ms"].values()) + row["other_ms"]
        assert total == pytest.approx(row["value_ms"], abs=0.005), row
    exports = []
    for name, main in (("port", timeline.main), ("jax", jtimeline.main)):
        out = tmp_path / f"fleet_trace_{name}.json"
        assert main([str(base), "--fleet", "--json",
                     "--export", str(out)]) == 0
        exports.append(out.read_text())
    assert exports[0] == exports[1]
    pids = {e.get("pid") for e in json.loads(exports[0])["traceEvents"]}
    assert len(pids) >= 3
    rows = [top.sample(n, p, now=now, timeout_s=0.05)
            for n, p in top.discover(base)]
    assert rows == [jtop.sample(n, p, now=now, timeout_s=0.05)
                    for n, p in jtop.discover(base)]
    assert [r["name"] for r in rows] == ["router", "replica 0",
                                         "replica 1"]
