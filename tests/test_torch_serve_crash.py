"""The port's crash plane against the JAX package: the request journal
(`serve/journal.py`), the chaos grammar (`testing/chaos.py`), the
restart supervisor (`supervisor.py`), crash replay through the port
engine, the supervised server killed mid-decode, and the port's `obs
doctor` reading the port's telemetry as the reference's does.

Re-expresses the reference's `TestJournal`, `TestServeChaosGrammar`,
`TestServeSupervisor` (tests/test_serve_crash.py), `TestCrashReplay` and
`TestSupervisedKill` (tests/test_serve.py). The journal keeps the
reference's record format byte for byte, so a journal written by either
package recovers the same resume, finished and poisoned sets in the
other; every plan string parses to the same faults in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from flax import traverse_util

from hyperion_tpu.obs import doctor as jdoctor
from hyperion_tpu.serve.journal import RequestJournal as JaxJournal
from hyperion_tpu.serve.queue import Request as JaxRequest
from hyperion_tpu.testing import chaos as jchaos
from hyperion_tpu_torch import supervisor
from hyperion_tpu_torch.obs import doctor
from hyperion_tpu_torch.obs.heartbeat import Heartbeat
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.journal import RequestJournal
from hyperion_tpu_torch.serve.queue import REJECT_POISONED, Request
from hyperion_tpu_torch.testing import chaos
from test_torch_serve import (  # noqa: F401 — `pair` is a fixture
    REPO,
    _drain,
    _prompts,
    jax_stream,
    pair,
)


def _req(n=4, rid="", cls=Request, **kw):
    kw.setdefault("max_new_tokens", 4)
    return cls(prompt_ids=np.arange(1, n + 1, dtype=np.int32), id=rid, **kw)


# ------------------------------------------------------------- journal


class TestJournal:
    def test_round_trip_resumes_unfinished_in_admit_order(self, tmp_path):
        jp = tmp_path / "j.jsonl"
        j = RequestJournal(jp)
        j.admit(_req(5, "a", max_new_tokens=8, temperature=0.7, top_k=5,
                     top_p=0.9, seed=42))
        j.admit(_req(3, "b", max_new_tokens=6))
        j.token("a", 17)
        j.token("a", 21)
        j.close()
        resume, finished, poisoned, clean = RequestJournal(jp).recover()
        assert not clean and not finished and not poisoned
        assert [r.id for r in resume] == ["a", "b"]
        ra, rb = resume
        assert ra.tokens == [17, 21] and rb.tokens == []
        assert (ra.max_new_tokens, ra.temperature, ra.top_k, ra.top_p,
                ra.seed) == (8, 0.7, 5, 0.9, 42)
        assert ra.replays == 1

    def test_finished_and_clean_close_replay_nothing(self, tmp_path):
        jp = tmp_path / "j.jsonl"
        j = RequestJournal(jp)
        j.admit(_req(4, "a"))
        j.token("a", 9)
        j.finish("a", "done")
        j.admit(_req(4, "b"))
        j.close_clean()
        resume, finished, poisoned, clean = RequestJournal(jp).recover()
        assert clean and resume == finished == poisoned == []
        assert RequestJournal(jp).pending_count() == 0

    def test_torn_tail_tolerated(self, tmp_path):
        jp = tmp_path / "j.jsonl"
        j = RequestJournal(jp)
        j.admit(_req(4, "a"))
        j.token("a", 7)
        j.close()
        with jp.open("a") as f:
            f.write('{"k":"tok","id":"a","to')  # torn mid-write
        (r,), _, _, _ = RequestJournal(jp).recover()
        assert r.id == "a" and r.tokens == [7]

    @pytest.mark.parametrize("toks, eos", [([5, 6, 7], None), ([5, 2], 2)],
                             ids=["budget", "eos"])
    def test_complete_output_recovers_as_finished(self, tmp_path, toks,
                                                  eos):
        jp = tmp_path / "j.jsonl"
        j = RequestJournal(jp)
        j.admit(_req(4, "a", max_new_tokens=3))
        for t in toks:
            j.token("a", t)
        j.close()
        resume, finished, _, _ = RequestJournal(jp).recover(eos_id=eos)
        assert resume == [] and [r.tokens for r in finished] == [toks]
        assert RequestJournal(jp).pending_count() == 0

    def test_poison_rule_quarantines_after_max_replays(self, tmp_path):
        jp = tmp_path / "j.jsonl"
        j = RequestJournal(jp)
        j.admit(_req(4, "evil"))
        j.close()
        for _ in range(2):
            r, _, p, _ = RequestJournal(jp).recover(max_replays=2)
            assert [x.id for x in r] == ["evil"] and p == []
        r, _, p, _ = RequestJournal(jp).recover(max_replays=2)
        assert r == [] and [x.id for x in p] == ["evil"]
        assert p[0].replays == 2
        assert RequestJournal(jp).recover(max_replays=2)[:3:2] == ([], [])

    def test_io_failure_disables_never_raises(self, tmp_path):
        fails = []

        def fault(tag):
            fails.append(tag)
            raise OSError("disk on fire")

        j = RequestJournal(tmp_path / "j.jsonl", fault=fault)
        j.admit(_req(4, "a"))  # must not raise
        assert not j.enabled and "disk on fire" in (j.error or "")
        j.token("a", 1)  # disabled: a silent no-op
        assert len(fails) == 1

    def test_journal_io_fail_chaos_clause(self, tmp_path):
        plan = chaos.ChaosPlan(chaos.parse_plan("journal_io_fail@p=1.0"))
        j = RequestJournal(tmp_path / "j.jsonl", fault=plan.journal_io)
        j.admit(_req(4, "a"))
        assert not j.enabled and "journal_io_fail" in (j.error or "")
        plan0 = chaos.ChaosPlan(chaos.parse_plan("journal_io_fail@p=0.0"))
        j0 = RequestJournal(tmp_path / "j0.jsonl", fault=plan0.journal_io)
        j0.admit(_req(4, "a"))
        assert j0.enabled

    def test_records_after_close_start_a_new_life(self, tmp_path):
        jp = tmp_path / "j.jsonl"
        j = RequestJournal(jp)
        j.admit(_req(4, "reused"))
        j.token("reused", 99)
        j.finish("reused", "done")
        j.close_clean()
        j2 = RequestJournal(jp)
        j2.admit(_req(4, "new"))
        j2.admit(_req(5, "reused"))  # same id, a new life, unfinished
        j2.token("reused", 7)
        j2.close()
        resume, _, _, clean = RequestJournal(jp).recover()
        assert not clean and [r.id for r in resume] == ["new", "reused"]
        assert resume[1].tokens == [7] and resume[1].prompt_len == 5


def _write_life(journal_cls, req_cls, path):
    """One journal life in either package: a finished request, a
    resumable one with tokens, an eos-complete one, a sampled one with no
    token yet, and one already replayed twice (poisoned at recovery)."""
    j = journal_cls(path)
    j.admit(_req(4, "done", req_cls))
    j.token("done", 3)
    j.finish("done", "done")
    j.admit(_req(6, "mid", req_cls, max_new_tokens=8))
    for t in (11, 12, 13):
        j.token("mid", t)
    j.admit(_req(3, "eos", req_cls, max_new_tokens=9))
    j.token("eos", 4)
    j.token("eos", 2)
    j.admit(_req(5, "hot", req_cls, temperature=0.8, top_k=7, top_p=0.9,
                 seed=5, deadline_s=3.5))
    j.admit(_req(2, "evil", req_cls))
    j.close()
    with path.open("a") as f:
        for n in (1, 2):
            f.write(json.dumps({"k": "replay", "id": "evil", "n": n},
                               separators=(",", ":")) + "\n")


def _sets(journal_cls, path):
    resume, finished, poisoned, clean = journal_cls(path).recover(
        max_replays=2, eos_id=2)

    def view(reqs):
        return [(r.id, r.prompt_ids.tolist(), list(r.tokens),
                 r.max_new_tokens, r.temperature, r.top_k, r.top_p, r.seed,
                 r.deadline_s, r.replays) for r in reqs]

    return view(resume), view(finished), view(poisoned), clean


class TestJournalInterchange:
    def test_records_byte_identical_to_the_reference(self, tmp_path):
        _write_life(RequestJournal, Request, tmp_path / "port.jsonl")
        _write_life(JaxJournal, JaxRequest, tmp_path / "jax.jsonl")
        assert (tmp_path / "port.jsonl").read_bytes() \
            == (tmp_path / "jax.jsonl").read_bytes()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_either_package_recovers_the_others_journal(self, tmp_path,
                                                        writer):
        """Written by one package, recovered by both (each from its own
        copy: recovery appends replay marks): the same resume, finished
        and poisoned sets, request fields included."""
        src = tmp_path / "j.jsonl"
        if writer == "port":
            _write_life(RequestJournal, Request, src)
        else:
            _write_life(JaxJournal, JaxRequest, src)
        shutil.copy(src, tmp_path / "j2.jsonl")
        port = _sets(RequestJournal, src)
        ref = _sets(JaxJournal, tmp_path / "j2.jsonl")
        assert port == ref
        resume, finished, poisoned, clean = port
        assert [r[0] for r in resume] == ["mid", "hot"]
        assert [r[0] for r in finished] == ["eos"]
        assert [r[0] for r in poisoned] == ["evil"] and not clean
        # after recovery the files still agree, and both owe the same
        assert src.read_bytes() == (tmp_path / "j2.jsonl").read_bytes()


# --------------------------------------------------------------- chaos


PLANS = [
    "crash@tick=3,journal_io_fail@p=0.25,poison_request@id=req_7",
    "kill@step=4,sigterm@step=5,nan_loss@step=6,stall@step=7:1.5",
    "kill@tick=1;sigterm@tick=2;stall@tick=3:0.25;slow_client@tick=4:0.5",
    "slowloris@tenant=team-a:0.01,crash@dispatch=3,conn_reset@p=0.1",
    "corrupt_ckpt@latest,io_fail@p=0.5",
]
BAD_PLANS = ["crash@step=3", "stall@tick=3", "journal_io_fail@p=1.5",
             "conn_reset@p=2", "wat@tick=1"]


class TestServeChaosGrammar:
    @pytest.mark.parametrize("spec", PLANS)
    def test_plans_parse_as_the_reference_does(self, spec):
        port = chaos.parse_plan(spec)
        ref = jchaos.parse_plan(spec)
        assert [dataclasses.astuple(f) for f in port] \
            == [dataclasses.astuple(f) for f in ref]
        assert [f.key for f in port] == [f.key for f in ref]

    @pytest.mark.parametrize("spec", BAD_PLANS)
    def test_bad_clauses_refused_as_the_reference_does(self, spec):
        with pytest.raises(ValueError) as port:
            chaos.parse_plan(spec)
        with pytest.raises(ValueError) as ref:
            jchaos.parse_plan(spec)
        assert str(port.value) == str(ref.value)

    def test_hooks_fire_only_in_their_unit(self, tmp_path):
        """Surviving each call is the assertion for the process-killing
        kinds: crash@dispatch never fires from a tick, poison only for
        its id, and a fired tick fault does not fire again in a new life
        sharing the state file."""
        plan = chaos.ChaosPlan(chaos.parse_plan(
            "crash@dispatch=3,poison_request@id=evil,stall@step=1:5"))
        t0 = time.monotonic()
        plan.on_tick(3)
        plan.on_tick(1)
        plan.on_request("innocent")
        plan.on_dispatch(2)
        assert time.monotonic() - t0 < 1.0 and not plan._fired
        state = tmp_path / "chaos_state.json"
        life1 = chaos.ChaosPlan(chaos.parse_plan("stall@tick=2:0"),
                                state_path=state)
        life1.on_tick(2)
        life2 = chaos.ChaosPlan(chaos.parse_plan("stall@tick=2:0"),
                                state_path=state)
        assert life2._fired == {"stall@tick=2:0.0"}

    def test_draw_streams_equal_the_reference(self):
        """Seeded coins: io_fail, journal_io_fail and conn_reset draw the
        reference's sequences, each from its own stream."""
        spec = "io_fail@p=0.5,journal_io_fail@p=0.5,conn_reset@p=0.5"

        def seq(mod):
            plan = mod.ChaosPlan(mod.parse_plan(spec), seed=3)
            out = []
            for _ in range(24):
                for hook, err in ((plan.io_fail, OSError),
                                  (plan.journal_io, OSError),
                                  (plan.conn_reset, ConnectionResetError)):
                    try:
                        hook("t")
                        out.append(0)
                    except err:
                        out.append(1)
            return out

        assert seq(chaos) == seq(jchaos)


# ---------------------------------------------------------- supervisor


class TestServeSupervisor:
    def test_loop_restarts_on_crash_and_gives_up(self):
        rcs = [70, 70, 70, 70]
        attempts = []

        def child(argv, env):
            attempts.append(env["HYPERION_ATTEMPT"])
            return rcs.pop(0)

        rc = supervisor.supervise_loop(
            ["serve"], decide=lambda rc: supervisor.Decision.restart(),
            max_restarts=2, run_child=child, sleep=lambda s: None,
            label="serve-supervisor")
        assert rc == supervisor.EXIT_GAVE_UP
        assert attempts == ["0", "1", "2"]

    @pytest.mark.parametrize("child_rc", [0, 2])
    def test_loop_stops_on_success_and_usage(self, child_rc):
        assert supervisor.supervise_loop(
            ["x"], decide=lambda rc: supervisor.Decision.restart(),
            max_restarts=5, run_child=lambda a, e: child_rc,
            sleep=lambda s: None) == child_rc

    def test_heartbeat_watchdog_kills_stale_child(self, tmp_path):
        runner = supervisor.heartbeat_watchdog(
            tmp_path / "heartbeat.json", stale_s=0.5, poll_s=0.05)
        t0 = time.monotonic()
        rc = runner([sys.executable, "-c", "import time; time.sleep(60)"],
                    None)
        assert rc == supervisor.RC_HUNG and time.monotonic() - t0 < 30

    def test_heartbeat_watchdog_fresh_child_exits_normally(self, tmp_path):
        hb = tmp_path / "heartbeat.json"
        hb.write_text("{}")
        runner = supervisor.heartbeat_watchdog(hb, stale_s=30.0, poll_s=0.05)
        assert runner([sys.executable, "-c", "raise SystemExit(7)"],
                      None) == 7

    def test_serve_strip_supervise_flags(self):
        from hyperion_tpu.serve.server import (
            _strip_supervise_flags as ref_strip,
        )
        from hyperion_tpu_torch.serve.server import _strip_supervise_flags

        for argv in (["--ckpt", "m.npz", "--supervise", "--max-restarts",
                      "3", "--hang-timeout", "5", "--journal", "j.jsonl"],
                     ["--max-restarts=3", "--hang-timeout=5",
                      "--supervise"]):
            assert _strip_supervise_flags(argv) == ref_strip(argv)
        assert _strip_supervise_flags(["--supervise", "--slots", "2"]) \
            == ["--slots", "2"]


# ------------------------------------------------- crash replay (engine)


def _engine(pair, journal, **kw):
    return Engine(pair[2], EngineConfig(slots=3, max_len=48, eos_id=None),
                  journal=journal, device="cpu", **kw)


def _streams(*sinks) -> dict[str, list[int]]:
    per: dict[str, list[int]] = {}
    for evs in sinks:
        for ev in evs:
            if ev.kind == "token" and ev.token is not None:
                per.setdefault(ev.request.id, []).append(ev.token)
    return per


def _crash_requests(sink):
    prompts = _prompts([5, 9, 4], seed=13)
    reqs = [Request(prompt_ids=p, max_new_tokens=5 + i, id=f"cr{i}",
                    sink=sink) for i, p in enumerate(prompts)]
    reqs.append(Request(prompt_ids=prompts[0], max_new_tokens=7, id="hot",
                        temperature=0.9, top_p=0.9, seed=21, sink=sink))
    return reqs


class TestCrashReplay:
    def test_crash_replay_bit_identical_and_exactly_once(self, tmp_path,
                                                         pair):
        """An fp32 engine abandoned mid-decode (nothing drained or closed
        beyond the journal's own appends) is replaced by a fresh engine
        over the same journal: every greedy stream equals JAX `generate`,
        the sampled one the uninterrupted port engine's, and the union of
        both engines' client streams holds each token once."""
        jp = tmp_path / "journal.jsonl"
        eng1 = _engine(pair, RequestJournal(jp))
        eng1.warmup([8, 16])
        s1: list = []
        reqs = _crash_requests(s1.append)
        for r in reqs:
            assert eng1.submit(r)[0]
        for _ in range(3):
            eng1.step()  # mid-decode; eng1 is now abandoned, unclosed

        tracer = Tracer(tmp_path / "telemetry.jsonl", run="replay_run")
        eng2 = _engine(pair, RequestJournal(jp), tracer=tracer)
        stats0 = eng2.warmup([8, 16])
        s2: list = []
        info = eng2.replay_pending(s2.append)
        assert info["resumed"] == 4 and info["poisoned"] == 0
        _drain(eng2)
        eng2.journal.close_clean()
        tracer.close()

        clean = _engine(pair, None)
        clean.warmup([8, 16])
        s0: list = []
        ref_reqs = _crash_requests(s0.append)
        for r in ref_reqs:
            clean.submit(r)
        _drain(clean)
        per, ref = _streams(s1, s2), _streams(s0)
        assert per == ref
        for i, r in enumerate(reqs[:3]):
            assert per[r.id] == jax_stream(pair, r.prompt_ids,
                                           r.max_new_tokens), r.id
        assert eng2.compile_stats() == stats0
        assert RequestJournal(jp).pending_count() == 0
        recs = [json.loads(x) for x in
                (tmp_path / "telemetry.jsonl").read_text().splitlines()]
        assert any(r.get("name") == "serve_prefill" and r.get("resumed")
                   for r in recs)

    def test_two_crashes_then_completion(self, tmp_path, pair):
        jp = tmp_path / "journal.jsonl"
        prompts = _prompts([6, 8], seed=17)
        budgets = [7, 6]
        streams: list[list] = []
        for life in range(3):
            eng = _engine(pair, RequestJournal(jp))
            eng.warmup([8, 16])
            sink: list = []
            streams.append(sink)
            if life == 0:
                for i, p in enumerate(prompts):
                    eng.submit(Request(prompt_ids=p, max_new_tokens=budgets[i],
                                       id=f"kt{i}", sink=sink.append))
            else:
                eng.replay_pending(sink.append)
            if life < 2:
                for _ in range(2):
                    eng.step()  # crash again mid-decode
            else:
                _drain(eng)
                eng.journal.close_clean()
        per = _streams(*streams)
        for i, p in enumerate(prompts):
            assert per[f"kt{i}"] == jax_stream(pair, p, budgets[i])
        assert RequestJournal(jp).pending_count() == 0

    def test_poisoned_replay_quarantines_with_event(self, tmp_path, pair):
        jp = tmp_path / "journal.jsonl"
        j = RequestJournal(jp)
        j.admit(Request(prompt_ids=_prompts([6], seed=23)[0],
                        max_new_tokens=4, id="evil"))
        j.close()
        with jp.open("a") as f:  # two prior lives already replayed it
            for n in (1, 2):
                f.write(json.dumps({"k": "replay", "id": "evil", "n": n})
                        + "\n")
        tracer = Tracer(tmp_path / "telemetry.jsonl", run="poison_run")
        eng = _engine(pair, RequestJournal(jp), tracer=tracer)
        got: list = []
        info = eng.replay_pending(got.append)
        eng.run()  # idle: drains at once, writing serve_end and metrics
        tracer.close()
        assert info == {"resumed": 0, "finished": 0, "poisoned": 1,
                        "clean": False}
        (ev,) = got
        assert ev.kind == "rejected" and ev.reason == REJECT_POISONED
        assert eng.metrics.summary()["poisoned"] == 1
        # the port's doctor names the pill from the port's stream, as
        # the reference's does
        now = time.time()
        d = doctor.diagnose(tmp_path / "telemetry.jsonl", now=now)
        assert d == jdoctor.diagnose(tmp_path / "telemetry.jsonl", now=now)
        assert d["poisoned_requests"] == ["evil"]
        assert any("poison pill" in o and "evil" in o for o in d["overload"])
        resume, _, poisoned, _ = RequestJournal(jp).recover()
        assert resume == [] and poisoned == []


class TestFlightPostMortem:
    def test_doctor_cites_the_port_flight_record(self, tmp_path, pair):
        """A port engine with telemetry, heartbeat and flight recorder
        dies mid-flight (no serve_end): the port's doctor reads the
        port's stream, heartbeat and flight.json and cites the record's
        final tick in its verdict, as the reference's does."""
        run = "serve_port_fl"
        tracer = Tracer(tmp_path / "telemetry.jsonl", run=run)
        hb = Heartbeat(tmp_path / "heartbeat.json", run=run, every=1)
        eng = _engine(pair, None, tracer=tracer, heartbeat=hb,
                      flight_path=tmp_path / "flight.json")
        eng.warmup([8, 16])
        for i, p in enumerate(_prompts([5, 9], seed=31)):
            eng.submit(Request(prompt_ids=p, max_new_tokens=8, id=f"fl{i}"))
        eng.hb.pulse(phase="serve", step=0)
        for _ in range(4):
            eng.step()
        tracer.flush()
        now = time.time() + 10_000
        d = doctor.diagnose(tmp_path, now=now)
        assert d == jdoctor.diagnose(tmp_path, now=now)
        assert d["verdict"] in ("hung", "crashed"), d["reason"]
        from hyperion_tpu_torch.obs.tickprof import (
            flight_final_tick,
            read_flight,
        )

        # the first eligible tick spills at once, then every 16
        tick = flight_final_tick(read_flight(tmp_path / "flight.json"))
        assert tick == 1
        assert d["flight"] and d["flight"]["final_tick"] == tick
        assert f"flight record: last spill at tick {tick}" in d["reason"]
        assert "2 active" in d["reason"]


# ------------------------------------------------- supervised subprocess


class TestSupervisedKill:
    def test_crash_under_supervise_stream_exactly_once(self, tmp_path,
                                                       pair):
        """`python -m hyperion_tpu_torch.serve.server --supervise` with a
        hard crash mid-decode (`crash@tick=2` = `os._exit`): one restart,
        the journal replays, and the client's one stdout stream carries
        every token once, in index order, equal to JAX `generate`; one
        done per request, the journal drained, the heartbeat's attempt
        1, a flight record, and a compile ledger in each life with no
        recompile."""
        from hyperion_tpu_torch.obs.tickprof import (
            flight_final_tick,
            read_flight,
        )

        flat = traverse_util.flatten_dict(pair[1]["params"], sep="/")
        ckpt = tmp_path / "tiny.npz"
        np.savez(ckpt, **{k: np.asarray(v) for k, v in flat.items()})
        jp, tele = tmp_path / "journal.jsonl", tmp_path / "t" / "tel.jsonl"
        prompts = _prompts([6, 7], seed=61)
        budgets = [12, 10]
        lines = "".join(
            json.dumps({"id": f"k{i}", "prompt_ids": p.tolist(),
                        "max_new_tokens": budgets[i]}) + "\n"
            for i, p in enumerate(prompts))
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   HYPERION_TELEMETRY=str(tele))
        env.pop("HYPERION_ATTEMPT", None)
        r = subprocess.run(
            [sys.executable, "-m", "hyperion_tpu_torch.serve.server",
             "--ckpt", str(ckpt), "--no-tokenizer", "--device", "cpu",
             "--dtype", "float32", "--max-len", "48", "--slots", "2",
             "--warmup-lens", "16", "--journal", str(jp), "--supervise",
             "--max-restarts", "2", "--hang-timeout", "0",
             "--chaos", "crash@tick=2"],
            input=lines, env=env, capture_output=True, text=True,
            timeout=300, cwd=tmp_path)
        assert r.returncode == 0, r.stderr[-3000:]
        assert r.stderr.count("[serve-supervisor] child exit 70") == 1
        # the supervisor consulted the port's doctor between lives: a
        # life gone without serve_end, its heartbeat still fresh
        (verdict,) = re.findall(
            r"\[serve-supervisor\] child exit 70; doctor verdict: (\w+);",
            r.stderr)
        assert verdict in ("running", "crashed"), r.stderr[-3000:]
        assert r.stdout.count("[chaos] firing crash@tick=2") == 1
        idx: dict[str, list[int]] = {}
        toks: dict[str, list[int]] = {}
        dones: dict[str, int] = {}
        for line in r.stdout.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # chaos chatter on the shared stdout
            if rec.get("event") == "token":
                idx.setdefault(rec["id"], []).append(rec["i"])
                toks.setdefault(rec["id"], []).append(rec["token"])
            elif rec.get("event") == "done":
                dones[rec["id"]] = dones.get(rec["id"], 0) + 1
        for i, p in enumerate(prompts):
            rid = f"k{i}"
            assert toks[rid] == jax_stream(pair, p, budgets[i]), rid
            assert idx[rid] == list(range(budgets[i])) and dones[rid] == 1
        assert RequestJournal(jp).pending_count() == 0
        records = [json.loads(x) for x in tele.read_text().splitlines()]
        assert any(x.get("name") == "request_admitted" and x.get("replayed")
                   for x in records)
        ledgers = [x for x in records if x.get("name") == "compile_ledger"]
        assert len(ledgers) == 2
        assert not any(x.get("name") == "recompile_after_warmup"
                       for x in records)
        hb = json.loads((tele.parent / "heartbeat.json").read_text())
        assert hb["attempt"] == 1
        assert flight_final_tick(read_flight(tele.parent / "flight.json")) \
            is not None
        # the port's doctor reads the last life as a drained restart, as
        # the reference's does
        now = time.time()
        d = doctor.diagnose(tele, now=now)
        assert d == jdoctor.diagnose(tele, now=now)
        assert d["verdict"] == "healthy" and d["attempt"] == 1
