"""The port's introspection plane against the JAX package: the tick
profiler and flight recorder (`obs/tickprof.py`), the compile ledger
(`obs/ledger.py`), the exposition socket and its control verbs
(`obs/export.py`), a live engine's exposition payload and verbs, and
the compile tier's no-recompile guarantee.

Re-expresses the reference's `TestTickProfiler`, `TestFlightRecorder`,
`TestCompileLedger`, `TestExposition`, `TestExpositionControl`
(tests/test_obs_live.py) and `TestNoRecompile`, `TestIntrospection`
(tests/test_serve.py). The host modules are copies, so on the same
inputs they give the JAX classes' snapshots; the engine's
`compile_stats()` has the JAX engine's keys and, on the CPU, counts the
distinct (surface, shape) keys it ran — flat after warmup across slot
churn, prefix hits, COW forks, preemption, spec ticks and chunks.
"""

from __future__ import annotations

import json
import socket as socket_mod
import time

import numpy as np
import pytest

from hyperion_tpu.models import llama as jl
from hyperion_tpu.obs import doctor as jdoctor
from hyperion_tpu.obs import export as jexport
from hyperion_tpu.obs import ledger as jledger
from hyperion_tpu.obs import tickprof as jtickprof
from hyperion_tpu.obs import top as top_mod
from hyperion_tpu.serve.engine import Engine as JaxEngine
from hyperion_tpu.serve.engine import EngineConfig as JaxEngineConfig
from hyperion_tpu_torch.obs import doctor, export, ledger, tickprof, top
from hyperion_tpu_torch.obs.registry import MetricsRegistry
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.graphs import STAT_KEYS
from hyperion_tpu_torch.serve.queue import Request
from hyperion_tpu_torch.utils.clock import VirtualClock
from test_torch_serve import (  # noqa: F401 — `pair` is a fixture
    _drain,
    _engine,
    _prompts,
    pair,
)

# ---------------------------------------------------- tick profiler


TICK_CASES = {
    # (records as (segments, total_s), clock advance, capacity, window)
    "dominant_and_other": ([({"device": 0.006, "journal": 0.002}, 0.010)]
                           * 4, 1.0, 256, 60.0),
    "window_cut_and_tail": ([({"slo": 0.001}, 0.001)] * 20, 10.0, 8, 25.0),
    "mixed": ([({"queue_pop": 0.001, "admit": 0.004, "device": 0.003},
                0.009), ({"draft": 0.002, "accept": 0.001}, 0.004),
               ({"sink": 0.005, "bt_upload": 0.0005}, 0.006)] * 3,
              2.5, 256, 30.0),
    "empty": ([], 1.0, 256, 60.0),
}


@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_tick_profiler_snapshots_equal_the_reference(case):
    recs, step, capacity, window = TICK_CASES[case]
    out = []
    for mod in (tickprof, jtickprof):
        clk = VirtualClock()
        tp = mod.TickProfiler(capacity=capacity, wall=clk)
        for i, (seg, total) in enumerate(recs):
            tp.record(i, seg, total)
            clk.advance(step)
        out.append((tp.snapshot(window_s=window, now=clk.t), tp.tail(5)))
    assert out[0] == out[1]
    if case == "empty":
        assert out[0][0]["dominant"] is None


class TestFlightRecorder:
    def _drive(self, mod, path):
        fr = mod.FlightRecorder(path, run="serve_x", spill_every=4)
        dues = []
        for tick in range(1, 12):
            dues.append(fr.due(tick))
            if dues[-1]:
                fr.note("recompile_after_warmup", executable="prefill",
                        tick=tick)
                fr.spill("periodic", {"ticks": [{"tick": tick}]},
                         tick=tick)
        fr.spill("sigterm", {"ticks": [{"tick": 40}, {"tick": 41}]},
                 tick=41)
        return dues, mod.read_flight(path)

    def test_spills_equal_the_reference(self, tmp_path):
        port = self._drive(tickprof, tmp_path / "port.json")
        ref = self._drive(jtickprof, tmp_path / "jax.json")
        assert port[0] == ref[0]

        def strip(doc):  # the wall clock of the spill and of each note
            return {**{k: v for k, v in doc.items() if k != "t_wall"},
                    "events": [{k: v for k, v in e.items() if k != "t_wall"}
                               for e in doc["events"]]}

        assert strip(port[1]) == strip(ref[1])
        assert tickprof.flight_final_tick(port[1]) == 41
        # either package reads the other's file
        assert jtickprof.read_flight(tmp_path / "port.json") == port[1]
        assert tickprof.FLIGHT_SCHEMA == jtickprof.FLIGHT_SCHEMA
        assert tickprof.SEGMENTS == jtickprof.SEGMENTS

    def test_null_recorder_torn_file_and_io_failure(self, tmp_path):
        fr = tickprof.null_flight_recorder()
        fr.note("x")
        fr.spill("periodic", {"a": 1}, tick=1)
        assert not fr.enabled and not fr.due(1)
        bad = tmp_path / "torn.json"
        bad.write_text("{not json")
        assert tickprof.read_flight(bad) is None
        blocker = tmp_path / "blocker"
        blocker.write_text("")  # a FILE where the parent dir must go
        fr = tickprof.FlightRecorder(blocker / "flight.json")
        fr.spill("periodic", {}, tick=1)
        assert not fr.enabled


# ----------------------------------------------------- compile ledger


def test_compile_ledger_equals_the_reference():
    out = []
    for mod in (ledger, jledger):
        led = mod.CompileLedger()
        base = {"tick_executables": 1, "prefill_executables": 2}
        checks = [led.check({"tick_executables": 9})]  # no baseline yet
        led.set_baseline(base)
        grown = {"tick_executables": 1, "prefill_executables": 3}
        checks += [led.check(base), led.check(grown), led.check(grown),
                   led.check({"tick_executables": 2,
                              "prefill_executables": 3})]
        rec = led.record_warmup(base, compile_s={"tick": 1.25},
                                costs={"tick_flops": 3.0}, total_s=2.0)
        out.append((checks, led.recompiles, dict(led.last_seen), rec))
    assert out[0] == out[1]
    assert out[0][1] == 2


# --------------------------------------------------------- exposition


def _payload():
    reg = MetricsRegistry()
    reg.counter("tokens").inc(42)
    reg.histogram("ttft_ms").observe(7.0)
    return lambda window_s=60.0: {
        "role": "engine", "phase": "serve", "active": 1,
        "metrics": reg.snapshot(), "windows": reg.windowed_snapshot(window_s)}


class TestExposition:
    def test_round_trip_read_by_both_packages(self, tmp_path):
        sock = export.exposition_path(tmp_path)
        assert sock == jexport.exposition_path(tmp_path) \
            == tmp_path / "obs.sock"
        assert export.exposition_path(tmp_path / "heartbeat.json") == sock
        with export.MetricsExporter(sock, _payload(), label="t-obs") as exp:
            assert exp.enabled
            for read in (export.read_exposition, jexport.read_exposition):
                doc = read(sock)
                assert doc["kind"] == "exposition" and doc["v"] == 1
                assert doc["metrics"]["counters"]["tokens"] == 42
                assert doc["windows"]["histograms"]["ttft_ms"]["p99"] == 7.0
        assert not sock.exists() and export.read_exposition(sock) is None

    def test_payload_error_stale_socket_and_refused_second(self, tmp_path):
        def bad(window_s=60.0):
            raise RuntimeError("boom")

        sock = tmp_path / "obs.sock"
        sock.touch()  # a crash leftover nobody listens on: reclaimed
        with export.MetricsExporter(sock, bad) as exp:
            assert "boom" in export.read_exposition(sock)["error"]
            assert exp.enabled
            second = export.MetricsExporter(sock, _payload()).start()
            assert not second.enabled  # refused, degraded
            second.close()
            assert "boom" in export.read_exposition(sock)["error"]
        assert not sock.exists()

    def test_control_round_trip_and_bare_clients(self, tmp_path):
        calls = []

        def control(req):
            calls.append(req)
            return {"status": "started", "dir": req.get("out")}

        sock = tmp_path / "obs.sock"
        with export.MetricsExporter(sock, lambda window_s=60.0:
                                    {"phase": "x"}, control_fn=control):
            assert export.read_exposition(sock)["phase"] == "x"
            for req_fn in (export.request_control, jexport.request_control):
                res = req_fn(sock, {"cmd": "profile", "out": "d"})
                assert res["kind"] == "control" and res["status"] == "started"
            assert calls == [{"cmd": "profile", "out": "d"}] * 2
            s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
            s.connect(str(sock))
            s.sendall(b"not json\n")
            data = b""
            while not data.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
            s.close()
            assert json.loads(data)["kind"] == "exposition"
        with export.MetricsExporter(sock, lambda window_s=60.0:
                                    {"phase": "y"}):
            res = export.request_control(sock, {"cmd": "profile"})
            assert res["kind"] == "exposition" and res["phase"] == "y"


# ------------------------------------------------ a live port engine


def _traced_engine(pair, tracer, **kw):
    return Engine(pair[2], EngineConfig(slots=3, max_len=48, eos_id=None),
                  tracer=tracer, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_engine(pair):
    """The JAX engine over the same tiny weights (built, never run: its
    payload keys and `compile_stats()` keys are what the port matches)."""
    model = jl.Llama(jl.llama_tiny_config(max_len=64, norm_impl="pallas"))
    return JaxEngine(model, pair[1], JaxEngineConfig(slots=3, max_len=48,
                                                     eos_id=None))


class TestEngineIntrospection:
    def test_exposition_payload_has_the_reference_keys(self, pair,
                                                       jax_engine):
        eng = _engine(pair)
        eng.warmup([8])
        eng.submit(Request(prompt_ids=_prompts([5], seed=22)[0],
                           max_new_tokens=4, id="intro0"))
        _drain(eng)
        doc, ref = eng.exposition(), jax_engine.exposition()
        assert set(doc) == set(ref)
        for key in ("memory", "act", "windows", "metrics"):
            assert set(doc[key]) == set(ref[key]), key
        assert set(eng.compile_stats()) == set(jax_engine.compile_stats()) \
            == set(STAT_KEYS.values())
        tp = doc["tickprof"]
        assert tp["ticks"] > 0 and tp["dominant"] in (
            "other", *jtickprof.SEGMENTS)
        mem = doc["memory"]
        assert mem["param_bytes"] == sum(
            p.numel() * p.element_size() for p in pair[2].parameters())
        assert mem["blocks_in_use_bytes"] == 0  # drained
        # the plain (CPU) read gathers every slot's chain each tick
        assert mem["kv_gather_bytes_per_tick"] \
            == 3 * eng._mb * eng._block_bytes
        assert doc["compile"] == {**eng.compile_stats(), "recompiles": 0}
        led = eng.ledger.warmup
        assert "tick" in led["compile_s"] and "copy" in led["compile_s"]
        assert any(k.startswith("prefill_b") for k in led["compile_s"])

    def test_control_verbs_and_obs_top_on_a_live_socket(self, pair,
                                                        tmp_path):
        """The verbs through the socket: class_brownout on and off is
        acknowledged and its gauge and `act` follow, an unknown verb
        answers an error, `profile` writes a trace; the port's `obs top`
        samples the live port engine, its row from the payload equal to
        the reference's."""
        tracer = Tracer(tmp_path / "telemetry.jsonl", run="intro")
        eng = _traced_engine(pair, tracer)
        eng.warmup([8, 16])
        stats0 = eng.compile_stats()
        for i, p in enumerate(_prompts([5, 9, 4, 6], seed=21)):
            eng.submit(Request(prompt_ids=p, max_new_tokens=6,
                               id=f"poll{i}"))
        sock = tmp_path / "obs.sock"
        with export.MetricsExporter(sock, eng.exposition,
                                    control_fn=eng.control):
            eng.step()
            for active, gauge in ((True, 1.0), (False, 0.0)):
                ack = export.request_control(
                    sock, {"cmd": "class_brownout", "active": active})
                assert ack["status"] == "ok" and ack["changed"]
                doc = export.read_exposition(sock)
                assert doc["act"]["class_brownout"] is active
                assert doc["metrics"]["gauges"]["serve_class_brownout"] \
                    == gauge
            again = export.request_control(
                sock, {"cmd": "class_brownout", "active": False})
            assert again["status"] == "ok" and not again["changed"]
            assert export.request_control(sock, {"cmd": "wat"})["status"] \
                == "error"
            assert export.request_control(
                sock, {"cmd": "profile"})["status"] == "error"
            out = tmp_path / "profile"
            res = export.request_control(
                sock, {"cmd": "profile", "out": str(out), "seconds": 0.2})
            assert res["status"] == "started"
            row = top.sample("process", tmp_path, timeout_s=2.0)
            assert top.ROW_KEYS == top_mod.ROW_KEYS
            assert set(top_mod.ROW_KEYS) <= set(row)
            assert row["source"] == "socket" and row["state"] == "live"
            assert row["dominant_segment"] is not None
            doc = export.read_exposition(sock, 2.0)
            blank = {k: None for k in top.ROW_KEYS}
            assert top._row_from_exposition(dict(blank), doc) \
                == top_mod._row_from_exposition(dict(blank), doc)
            _drain(eng)
        deadline = time.monotonic() + 30
        while not (out / "trace.json").exists() \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert (out / "trace.json").exists()
        tracer.close()
        assert eng.compile_stats() == stats0 and eng.ledger.recompiles == 0
        recs = [json.loads(x) for x in
                (tmp_path / "telemetry.jsonl").read_text().splitlines()]
        names = [r.get("name") for r in recs]
        assert names.count("class_brownout") == 2
        assert "profile_requested" in names and "compile_ledger" in names

    def test_profile_starts_and_stops_only_between_ticks(self, pair,
                                                         tmp_path):
        """`profile` turns the profiler on and off under the engine's
        tick gate, which every `step` holds: the start waits for the tick
        in flight, and the stop for the tick running when the window
        ends (a stop that overlapped CUDA graph replays on the serving
        thread hung on the card: scripts/profile_torch_trace_stop.py)."""
        import threading

        from hyperion_tpu_torch.utils import profiling

        eng = _engine(pair)
        eng.warmup([8])
        held, real = [], eng._step

        def step():
            held.append(eng._tick_gate.locked())
            return real()

        eng._step = step
        eng.submit(Request(prompt_ids=_prompts([5], seed=23)[0],
                           max_new_tokens=3, id="gate0"))
        eng.step()
        assert held == [True]
        out, box = tmp_path / "profile", {}
        eng._tick_gate.acquire()  # a tick in flight
        t = threading.Thread(target=lambda: box.update(eng.control(
            {"cmd": "profile", "out": str(out), "seconds": 0.1})))
        t.start()
        t.join(0.5)
        assert t.is_alive() and not box  # the start waits for the tick
        eng._tick_gate.release()
        t.join(30)
        assert box["status"] == "started"
        eng._tick_gate.acquire()  # a tick running past the window's end
        time.sleep(0.6)
        assert not (out / "trace.json").exists()  # the stop waits for it
        eng._tick_gate.release()
        deadline = time.monotonic() + 30
        while profiling._TRACE_ACTIVE and time.monotonic() < deadline:
            time.sleep(0.05)
        assert (out / "trace.json").exists()
        _drain(eng)


# ------------------------------------------------- recompile guarantee


def _churn(eng, seed, n=10, lens=(3, 16), budgets=(1, 8)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 250, 9)
    for i in range(n):
        tail = rng.integers(1, 250, int(rng.integers(*lens)))
        ids = np.concatenate([shared, tail])[:lens[1]] if i % 2 else tail
        eng.submit(Request(
            prompt_ids=ids.astype(np.int32),
            max_new_tokens=int(rng.integers(*budgets)),
            temperature=float(rng.choice([0.0, 0.7, 1.3])),
            top_k=int(rng.choice([0, 5, 20])),
            top_p=float(rng.choice([1.0, 0.9])), seed=i))
        eng.step()
    _drain(eng)


class TestNoRecompile:
    @pytest.mark.parametrize("kw", [
        dict(block_size=4),
        dict(block_size=4, num_blocks=14, admission="optimistic"),
        dict(block_size=4, spec_k=2, draft="ngram"),
        dict(block_size=4, prefill_chunk=8, admission="optimistic",
             num_blocks=16),
    ], ids=["churn_prefix_cow", "preemption", "spec", "chunk"])
    def test_churn_never_grows_compile_stats(self, pair, kw):
        """After warmup, admission, refill, prefix hits and COW forks,
        preemption, spec ticks and chunk segments add no graph: the
        counts stay flat and the ledger records no recompile."""
        eng = _engine(pair, **kw)
        stats0 = eng.warmup([16])
        # long budgets make the optimistic pool run dry mid-decode
        _churn(eng, seed=7, budgets=(12, 24) if "num_blocks" in kw
               else (1, 8))
        assert eng.compile_stats() == stats0
        assert eng.ledger.recompiles == 0
        s = eng.metrics.summary()
        if kw.get("admission") == "optimistic" and "prefill_chunk" not in kw:
            assert s["preempted"] >= 1
        if not kw.get("spec_k") and "prefill_chunk" not in kw \
                and "num_blocks" not in kw:
            assert s["prefix_hits"] >= 1 and s["cow_copies"] >= 1
        if kw.get("prefill_chunk"):
            assert eng.chunk_segments >= 1
            assert stats0["chunk_executables"] == 1
        if kw.get("spec_k"):
            assert stats0["spec_tick_executables"] == 1

    def test_warmup_builds_one_tick_and_one_prefill_per_bucket(self, pair):
        eng = _engine(pair, max_len=24)
        assert eng.compile_stats() == dict.fromkeys(STAT_KEYS.values(), 0)
        stats = eng.warmup([4, 8, 16, 23])
        assert stats == {"tick_executables": 1, "prefill_executables": 3,
                         "copy_executables": 1, "spec_tick_executables": 0,
                         "chunk_executables": 0}
        # optimistic admission warms the whole ladder to max_len
        opt = _engine(pair, admission="optimistic", max_len=16, slots=5)
        assert opt.warmup([8])["prefill_executables"] == 2

    def test_shape_churn_raises_exactly_one_recompile_incident(
            self, pair, tmp_path):
        """A prompt past the warmed ladder runs a new prefill shape: the
        ledger counts one recompile, the stream and the flight record
        say so, and the port's doctor names the executable as the
        reference's does."""
        tracer = Tracer(tmp_path / "telemetry.jsonl", run="churn")
        eng = _traced_engine(pair, tracer,
                             flight_path=tmp_path / "flight.json")
        eng.warmup([8])
        eng.submit(Request(prompt_ids=_prompts([20], seed=23)[0],
                           max_new_tokens=3, id="churn0"))
        eng.run()
        tracer.close()
        assert eng.ledger.recompiles == 1
        assert eng.metrics.reg.snapshot()["counters"][
            "serve_recompiles"] == 1
        recs = [json.loads(x) for x in
                (tmp_path / "telemetry.jsonl").read_text().splitlines()]
        (ev,) = [r for r in recs if r.get("name") == "recompile_after_warmup"]
        assert ev["executable"] == "prefill_executables"
        assert ev["last_prefill_bucket"] == 32
        flight = tickprof.read_flight(tmp_path / "flight.json")
        assert any(e["name"] == "recompile_after_warmup"
                   for e in flight["events"])
        now = time.time()
        d = doctor.diagnose(tmp_path / "telemetry.jsonl", now=now)
        assert d == jdoctor.diagnose(tmp_path / "telemetry.jsonl", now=now)
        assert "recompile after warmup" in d["reason"]
        assert "prefill_executables" in d["reason"]
