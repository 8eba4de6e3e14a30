"""Brownout, SLO alerting and the server's feature flags in the port.

Re-expresses the reference's `TestBrownout` (overload sheds doomed
queued requests and clamps new budgets, with hysteresis) and
`TestSLOLivePlane` (an overloaded engine raises exactly one alert and
clears it after the load drops, with no flapping) from
tests/test_serve.py; the SLO windows run on a fake clock here, so the
drill needs no sleeping. Then the JSONL server with every new flag on,
through its subprocess, against JAX `generate`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
from flax import traverse_util

from hyperion_tpu_torch.obs.registry import MetricsRegistry
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.metrics import ServeMetrics
from hyperion_tpu_torch.serve.queue import REJECT_SHED, Request
from test_torch_serve import (  # noqa: F401 — `pair` is a fixture
    ORACLE_PROMPTS,
    REPO,
    _assert_oracle,
    _budget,
    _drain,
    _prompts,
    jax_stream,
    pair,
)


def _events(path) -> list[dict]:
    return [r for r in (json.loads(x) for x in
                        path.read_text().splitlines())
            if r.get("kind") == "event"]


class TestBrownout:
    def test_shed_clamp_and_hysteresis(self, pair, tmp_path):
        tracer = Tracer(tmp_path / "telemetry.jsonl", run="brownout_run")
        eng = Engine(pair[2], EngineConfig(
            slots=2, max_len=48, queue_capacity=16, brownout=True,
            brownout_depth=2, brownout_clamp=2), tracer=tracer,
            device="cpu")
        keepers = [Request(prompt_ids=p, max_new_tokens=3, id=f"bk{i}")
                   for i, p in enumerate(_prompts([6] * 4, seed=41))]
        doomed = [Request(prompt_ids=p, max_new_tokens=3, id=f"bd{i}",
                          deadline_s=0.004)
                  for i, p in enumerate(_prompts([6] * 2, seed=43))]
        shed: list = []
        for r in keepers + doomed:
            r.sink = lambda ev: shed.append(ev) \
                if ev.kind == "rejected" else None
            ok, reason = eng.submit(r)
            assert ok, reason
        time.sleep(0.01)  # the doomed deadlines pass
        eng.step()  # depth 6 >= 2: enter and shed
        assert eng._governor.active
        assert eng.metrics.summary()["shed"] == 2
        assert all(r.finish_reason == REJECT_SHED for r in doomed)
        assert sorted(ev.request.id for ev in shed) == ["bd0", "bd1"]
        # clamp while active: an 8-token ask is served at 2
        clamped = Request(prompt_ids=_prompts([6], seed=47)[0],
                          max_new_tokens=8, id="bclamp")
        assert eng.submit(clamped)[0]
        _drain(eng)
        assert clamped.clamped_from == 8 and len(clamped.tokens) == 2
        assert not eng._governor.active  # hysteresis exited at depth 0
        summary = eng.run()
        tracer.close()
        assert summary["brownout_clamped"] == 1
        assert summary["brownout_active"] is False
        assert summary["by_class"]["interactive"]["shed"] == 2
        _assert_oracle(pair, keepers)
        events = _events(tmp_path / "telemetry.jsonl")
        names = [r["name"] for r in events]
        assert "brownout_enter" in names and "brownout_exit" in names
        shed_recs = [r for r in events if r["name"] == "request_rejected"
                     and r.get("reason") == REJECT_SHED]
        assert len(shed_recs) == 2
        assert all(r["shed"] and r["queued_s"] is not None
                   for r in shed_recs)
        (adm,) = [r for r in events if r["name"] == "request_admitted"
                  and r["request"] == "bclamp"]
        assert adm["clamped_from"] == 8 and adm["max_new_tokens"] == 2

    def test_off_by_default(self, pair):
        eng = Engine(pair[2], EngineConfig(slots=2, max_len=48),
                     device="cpu")
        assert eng._governor is None and eng.slo is None
        req = Request(prompt_ids=_prompts([6], seed=47)[0],
                      max_new_tokens=8)
        eng.submit(req)
        assert req.clamped_from is None


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class TestSLOLivePlane:
    def test_ttft_alert_raises_once_then_clears(self, pair, tmp_path):
        """A micro TTFT target that every prefill breaches, windows of
        0.5 s and 1 s on a fake clock: one alert, held while both windows
        still burn, cleared once both drain."""
        clock = _FakeClock()
        tracer = Tracer(tmp_path / "telemetry.jsonl", run="slo_live")
        eng = Engine(pair[2], EngineConfig(
            slots=3, max_len=48, slo_ttft_p99_ms=0.001, slo_fast_s=0.5,
            slo_slow_s=1.0), metrics=ServeMetrics(MetricsRegistry(clock)),
            tracer=tracer, device="cpu")
        # six first tokens meet the quantile evidence floor of five
        reqs = [Request(prompt_ids=p, max_new_tokens=4, id=f"slo{i}")
                for i, p in enumerate(_prompts([5, 9, 4, 6, 7, 8],
                                               seed=11))]
        for r in reqs:
            assert eng.submit(r)[0]
        _drain(eng)
        assert not eng.slo.active  # the rate limit held evaluation back
        clock.t += 0.2
        eng.step()
        assert eng.slo.active_names() == ["ttft_p99"]
        clock.t += 0.3  # both windows still hold the breach: no flap
        eng.step()
        assert eng.slo.active_names() == ["ttft_p99"]
        clock.t += 1.0  # both windows drained
        eng.step()
        assert not eng.slo.active
        reg = eng.metrics.reg
        assert reg.counter("serve_alerts_raised").value == 1
        assert reg.counter("serve_alerts_cleared").value == 1
        assert reg.gauge("serve_alerts_active").value == 0.0
        assert eng.run()["alerts_raised"] == 1
        tracer.close()
        events = _events(tmp_path / "telemetry.jsonl")
        (raised,) = [r for r in events if r["name"] == "alert_raised"]
        assert raised["alert"] == "ttft_p99"
        assert raised["burn_fast"] > 1.0 and raised["burn_slow"] > 1.0
        assert sum(r["name"] == "alert_cleared" for r in events) == 1

    def test_reject_and_availability_alerts_on_door_rejects(self, pair):
        clock = _FakeClock()
        eng = Engine(pair[2], EngineConfig(
            slots=2, max_len=48, queue_capacity=2, slo_reject_rate=0.1,
            slo_availability=0.99, slo_fast_s=0.5, slo_slow_s=1.0),
            metrics=ServeMetrics(MetricsRegistry(clock)), device="cpu")
        oks = [eng.submit(Request(prompt_ids=p, max_new_tokens=2))[0]
               for p in _prompts([5] * 5, seed=12)]
        assert oks == [True, True, False, False, False]
        _drain(eng)
        clock.t += 0.2
        eng.step()
        assert eng.slo.active_names() == ["availability", "reject_rate"]

    def test_heartbeat_carries_alerts(self, pair, tmp_path):
        from hyperion_tpu_torch.obs.heartbeat import Heartbeat

        clock = _FakeClock()
        hb_path = tmp_path / "heartbeat.json"
        eng = Engine(pair[2], EngineConfig(
            slots=2, max_len=48, queue_capacity=2, slo_reject_rate=0.1,
            slo_fast_s=0.5, slo_slow_s=1.0),
            metrics=ServeMetrics(MetricsRegistry(clock)),
            heartbeat=Heartbeat(hb_path), device="cpu")
        for p in _prompts([5] * 3, seed=12):
            eng.submit(Request(prompt_ids=p, max_new_tokens=2))
        _drain(eng)
        clock.t += 0.2
        eng.step()
        assert json.loads(hb_path.read_text())["alerts"] == ["reject_rate"]


class TestServerFlags:
    def test_jsonl_subprocess_with_every_feature(self, pair, tmp_path):
        """Speculation, 8-token chunks, the host tier over an undersized
        pool, brownout and SLO targets, all through the CLI: tokens equal
        JAX `generate`, and the drained host store lands next to the
        telemetry stream."""
        flat = traverse_util.flatten_dict(pair[1]["params"], sep="/")
        ckpt = tmp_path / "tiny.npz"
        np.savez(ckpt, **{k: np.asarray(v) for k, v in flat.items()})
        lines = [json.dumps({"id": f"q{i}", "prompt_ids": p.tolist(),
                             "max_new_tokens": _budget(i)})
                 for i, p in enumerate(ORACLE_PROMPTS[:4])]
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   HYPERION_TELEMETRY=str(tmp_path / "t" / "tel.jsonl"))
        proc = subprocess.run(
            [sys.executable, "-m", "hyperion_tpu_torch.serve.server",
             "--device", "cpu", "--dtype", "float32", "--ckpt", str(ckpt),
             "--no-tokenizer", "--max-len", "64", "--slots", "2",
             "--block-size", "8", "--num-blocks", "9",
             "--admission", "optimistic", "--spec-k", "3",
             "--draft", "ngram", "--prefill-chunk", "8",
             "--host-cache-mb", "4", "--brownout", "--brownout-clamp",
             "64", "--slo-ttft-p99-ms", "60000", "--slo-availability",
             "0.5"],
            input="\n".join(lines) + "\n", capture_output=True, text=True,
            cwd=tmp_path, env=env, timeout=240)
        assert proc.returncode == 0, proc.stderr
        recs = [json.loads(x) for x in proc.stdout.splitlines()]
        for i, p in enumerate(ORACLE_PROMPTS[:4]):
            toks = [r["token"] for r in recs
                    if r["id"] == f"q{i}" and r["event"] == "token"]
            assert toks == jax_stream(pair, p, _budget(i)), f"q{i}"
        assert (tmp_path / "t" / "hostcache" / "index.json").exists()
        events = _events(tmp_path / "t" / "tel.jsonl")
        (start,) = [r for r in events if r["name"] == "serve_start"]
        assert start["host_cache_mb"] == 4
        assert any(r["name"] == "prefill_chunked" for r in events)
