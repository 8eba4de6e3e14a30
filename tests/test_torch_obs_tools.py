"""The port's run-health tools against the JAX package's, on the golden
telemetry fixtures (`tests/data/telemetry/`): `obs doctor`
(`diagnose`, its markdown and its exit codes), `obs summarize`, `obs
diff` with `--history`, `obs trace` and `obs trace --fleet`, and `obs
top` with every socket dead (the heartbeat fallback), each at a frozen
clock. Also the `obs` verb of the port's CLI, and a subprocess that
imports every new module and the three supervisors without loading
jax, the JAX package or torch.

The port's modules are copies over the port's heartbeat, registry,
tickprof and timeline, so on the same files they must give the
reference's dicts, text and exit codes exactly.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from hyperion_tpu.obs import diff as jdiff
from hyperion_tpu.obs import doctor as jdoctor
from hyperion_tpu.obs import fleet_trace as jfleet
from hyperion_tpu.obs import report as jreport
from hyperion_tpu.obs import timeline as jtimeline
from hyperion_tpu.obs import top as jtop
from hyperion_tpu_torch.obs import diff, doctor, fleet_trace, report, timeline
from hyperion_tpu_torch.obs import top
from hyperion_tpu_torch.obs.heartbeat import read_heartbeat

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "data" / "telemetry"
NAMES = ("crashed", "healthy", "hung", "nan", "serve", "sim", "slo",
         "stalled", "fleet")
# seconds past each fixture's last beat: a fresh vantage (a live loop)
# and a stale one (staleness outranks a stall: "stalled" turns "hung")
VANTAGE = {"fresh": 30.0, "stale": 10_000.0}


def _js(x) -> str:
    """Canonical text of a result: NaN-safe equality of nested dicts."""
    return json.dumps(x, sort_keys=True, default=str)


def _now(name: str, vantage: str) -> float:
    return read_heartbeat(FIXTURES / name / "heartbeat.json")["t_wall"] \
        + VANTAGE[vantage]


def _run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ------------------------------------------------------------- doctor


@pytest.mark.parametrize("vantage", sorted(VANTAGE))
@pytest.mark.parametrize("name", NAMES)
def test_diagnose_equals_the_reference(name, vantage):
    now = _now(name, vantage)
    ours = doctor.diagnose(FIXTURES / name, now=now)
    ref = jdoctor.diagnose(FIXTURES / name, now=now)
    assert _js(ours) == _js(ref)
    assert doctor.render_markdown(ours) == jdoctor.render_markdown(ref)
    for replica in sorted((FIXTURES / name).glob("replica_*")):
        assert _js(doctor.diagnose(replica, now=now)) \
            == _js(jdoctor.diagnose(replica, now=now))


@pytest.mark.parametrize("name", NAMES)
def test_doctor_main_text_and_exit_code_equal_the_reference(name, capsys):
    argv = [str(FIXTURES / name), "--now", str(_now(name, "fresh"))]
    ours = _run(doctor.main, argv, capsys)
    assert ours == _run(jdoctor.main, argv, capsys)
    assert ours[0] == doctor.EXIT_BY_VERDICT[
        doctor.diagnose(FIXTURES / name, now=_now(name, "fresh"))["verdict"]]
    js = _run(doctor.main, [*argv, "--json"], capsys)
    assert js == _run(jdoctor.main, [*argv, "--json"], capsys)


def test_doctor_constants_are_the_references():
    for k in ("STALE_S", "STALL_RATIO", "INPUT_BOUND_FRAC",
              "TAIL_DOMINANT_FRAC", "SPEC_ACCEPT_FLOOR",
              "HOST_SEGMENT_FRAC", "RSS_CLIMB_RATIO", "EXIT_BY_VERDICT",
              "_TERMINAL_EVENTS", "_STEP_SPANS", "_FATAL_KINDS",
              "_SEGMENT_HINTS"):
        assert getattr(doctor, k) == getattr(jdoctor, k), k


def test_doctor_empty_and_missing_targets(tmp_path, capsys):
    assert _run(doctor.main, [str(tmp_path / "nope")], capsys) \
        == _run(jdoctor.main, [str(tmp_path / "nope")], capsys)
    (tmp_path / "telemetry.jsonl").write_text("not json\n")
    ours = _run(doctor.main, [str(tmp_path)], capsys)
    assert ours == _run(jdoctor.main, [str(tmp_path)], capsys)
    assert ours[0] == 2


# ---------------------------------------------------------- summarize


@pytest.mark.parametrize("name", NAMES)
def test_summarize_equals_the_reference(name, capsys):
    tele = FIXTURES / name / "telemetry.jsonl"
    ours, ref = report.summarize(tele), jreport.summarize(tele)
    assert _js(ours) == _js(ref)
    assert report.render_markdown(ours) == jreport.render_markdown(ref)
    for argv in (["summarize", str(tele)],
                 ["summarize", str(tele), "--json"],
                 ["summarize", str(tele), "--list-runs"],
                 ["summarize", str(tele), "--run", "no_such_run"]):
        assert _run(report.main, argv, capsys) \
            == _run(jreport.main, argv, capsys), argv


# --------------------------------------------------------------- diff


DIFF_PAIRS = [("healthy", "stalled"), ("stalled", "healthy"),
              ("healthy", "nan"), ("serve", "slo"), ("sim", "fleet"),
              ("healthy", "healthy"), ("crashed", "hung")]


@pytest.mark.parametrize("a, b", DIFF_PAIRS)
def test_diff_table_and_exit_code_equal_the_reference(a, b, capsys):
    sa, sb = diff.load_summary(FIXTURES / a), diff.load_summary(FIXTURES / b)
    ja, jb = jdiff.load_summary(FIXTURES / a), jdiff.load_summary(FIXTURES / b)
    ours, ref = diff.diff(sa, sb), jdiff.diff(ja, jb)
    assert _js(ours) == _js(ref)
    assert diff.render_markdown(ours) == jdiff.render_markdown(ref)
    for extra in ([], ["--json"], ["--threshold", "0.5"]):
        argv = [str(FIXTURES / a), str(FIXTURES / b), *extra]
        assert _run(diff.main, argv, capsys) \
            == _run(jdiff.main, argv, capsys), argv


@pytest.mark.parametrize("globs", [
    ["BENCH_r*.json"], ["MULTICHIP_r*.json", "BASELINE.json"],
    ["tests/data/telemetry/*/telemetry.jsonl"]])
def test_diff_history_equals_the_reference(globs, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    for extra in ([], ["--json"]):
        argv = ["--history", *globs, *extra]
        ours = _run(diff.main, argv, capsys)
        assert ours == _run(jdiff.main, argv, capsys), argv
        assert ours[0] == 0 and ours[1]
    paths = sorted(str(p) for g in globs for p in REPO.glob(g))
    assert _js(diff.history(paths)) == _js(jdiff.history(paths))
    assert diff.METRICS == jdiff.METRICS


def test_diff_normalizes_every_bench_doc_like_the_reference():
    for path in sorted(REPO.glob("*_r*.json")) + [REPO / "BASELINE.json"]:
        doc = json.loads(path.read_text())
        if isinstance(doc, dict):
            assert diff.normalize(doc) == jdiff.normalize(doc), path.name


# ------------------------------------------------- trace and --fleet


def test_obs_trace_on_the_serve_fixture_equals_the_reference(tmp_path,
                                                             capsys):
    out = tmp_path / "trace.json"
    argv = [str(FIXTURES / "serve"), "--export", str(out)]
    ours = _run(timeline.main, argv, capsys)
    ours_trace = out.read_text()
    ref = _run(jtimeline.main, argv, capsys)
    assert ours == ref and ours[0] == 0
    assert ours_trace == out.read_text()
    for extra in (["--json"], ["--top", "2"]):
        argv = [str(FIXTURES / "serve"), "--export", "none", *extra]
        assert _run(timeline.main, argv, capsys) \
            == _run(jtimeline.main, argv, capsys)
    missing = [str(tmp_path / "none")]
    assert _run(timeline.main, missing, capsys) \
        == _run(jtimeline.main, missing, capsys)


def test_fleet_attribution_equals_the_reference(tmp_path, capsys):
    base = FIXTURES / "fleet"
    ours, ref = fleet_trace.assemble(base), jfleet.assemble(base)
    att, jatt = fleet_trace.attribution(ours), jfleet.attribution(ref)
    assert _js(att) == _js(jatt) and att["rows"]
    for row in att["rows"]:  # the components sum to the measured total
        total = sum(row["components_ms"].values()) + row["other_ms"]
        assert total == pytest.approx(row["value_ms"], abs=0.005), row
    assert fleet_trace.tail_incidents(att["rows"]) \
        == jfleet.tail_incidents(jatt["rows"])
    assert _js(fleet_trace.chrome_fleet_trace(ours)) \
        == _js(jfleet.chrome_fleet_trace(ref))
    out = tmp_path / "fleet.json"
    for extra in (["--json"], []):
        argv = [str(base), "--fleet", "--export", str(out), *extra]
        ours_cli = _run(timeline.main, argv, capsys)
        ours_file = out.read_text()
        assert ours_cli == _run(jtimeline.main, argv, capsys)
        assert ours_cli[0] == 0 and ours_file == out.read_text()


# ---------------------------------------------------------------- top


@pytest.mark.parametrize("name", NAMES)
def test_top_heartbeat_fallback_equals_the_reference(name, capsys,
                                                     monkeypatch):
    """No process answers its socket, so every row comes from its
    heartbeat; `--once` prints the same frame at the same frozen
    time."""
    now = _now(name, "fresh")
    base = FIXTURES / name
    assert top.discover(base) == jtop.discover(base)
    rows = [top.sample(n, d, now=now, timeout_s=0.05)
            for n, d in top.discover(base)]
    jrows = [jtop.sample(n, d, now=now, timeout_s=0.05)
             for n, d in jtop.discover(base)]
    assert rows == jrows and all(r["source"] == "heartbeat" for r in rows)
    for color in (False, True):
        assert top.render(rows, str(base), window_s=60.0, color=color,
                          now=now) \
            == jtop.render(jrows, str(base), window_s=60.0, color=color,
                           now=now)
    monkeypatch.setattr(time, "time", lambda: now)
    for extra in (["--once"], ["--once", "--json"]):
        argv = [str(base), "--timeout", "0.05", *extra]
        assert _run(top.main, argv, capsys) == _run(jtop.main, argv, capsys)


# ---------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [
    ["obs", "doctor", "nan"], ["obs", "doctor", "stalled", "--json"],
    ["obs", "summarize", "serve/telemetry.jsonl"],
    ["obs", "diff", "healthy", "stalled"],
    ["obs", "trace", "fleet", "--fleet", "--export", "none"],
    ["obs", "top", "fleet", "--once", "--no-color"]])
def test_cli_obs_verb_dispatches_like_the_reference(argv, capsys,
                                                    monkeypatch):
    from hyperion_tpu.cli.main import main as jmain
    from hyperion_tpu_torch.cli.main import main as pmain

    monkeypatch.chdir(FIXTURES)
    monkeypatch.setattr(time, "time", lambda: _now("fleet", "fresh"))
    ours = _run(pmain, argv, capsys)
    assert ours == _run(jmain, argv, capsys)


def test_new_modules_import_neither_jax_nor_torch():
    """The tools and the supervisors that consult them run where no
    CUDA context may exist (the router, the supervising parents)."""
    mods = ["hyperion_tpu_torch.obs.doctor", "hyperion_tpu_torch.obs.report",
            "hyperion_tpu_torch.obs.diff", "hyperion_tpu_torch.obs.top",
            "hyperion_tpu_torch.obs.fleet_trace",
            "hyperion_tpu_torch.obs.timeline",
            "hyperion_tpu_torch.serve.simulate",
            "hyperion_tpu_torch.train.supervisor",
            "hyperion_tpu_torch.serve.server",
            "hyperion_tpu_torch.serve.router",
            "hyperion_tpu_torch.cli.main"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from hyperion_tpu_torch.obs.doctor import diagnose\n"
        f"diagnose({str(FIXTURES / 'fleet')!r})\n"
        "from hyperion_tpu_torch.serve.simulate import main\n"
        "main(['--list'])\n"
        "bad = sorted(m for m in sys.modules"
        " if m in ('torch', 'jax', 'hyperion_tpu')"
        " or m.startswith(('torch.', 'jax.', 'hyperion_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
