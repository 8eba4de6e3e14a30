"""Profiler trace capture — `hyperion_tpu/utils/profiling.py` on
`torch.profiler`.

`capture()` wraps a code region in a `torch.profiler` trace (CPU ops and,
on the card, the CUDA kernels CUPTI sees) written as a Chrome trace;
`annotate()` names a sub-region in it. `on_demand_trace()` is the
`profile` control verb of a live serving loop (obs/export.py): it starts
a trace and returns at once, and the trace stops itself after the asked
seconds.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import torch

TRACE_NAME = "trace.json"  # the Chrome trace each capture writes


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def capture(trace_dir: str | Path | None):
    """Context manager: profile the enclosed region into
    `trace_dir/trace.json` (Perfetto or chrome://tracing). None = no-op,
    so call sites can pass the config value straight through."""
    if not trace_dir:
        yield None
        return
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield trace_dir
    prof.export_chrome_trace(str(trace_dir / TRACE_NAME))
    print(f"[profiling] trace written to {trace_dir / TRACE_NAME}")


def annotate(name: str):
    """Named sub-region inside a capture (shows as a span in the trace)."""
    return torch.profiler.record_function(name)


# on-demand tracing (the `obs profile` control verb): one trace at a
# time per process — the CUDA activity tracer is process-wide
_TRACE_LOCK = threading.Lock()
_TRACE_ACTIVE: list[str] = []


def on_demand_trace(out_dir: str | Path, seconds: float,
                    gate=None) -> dict:
    """Trace for `seconds` into `out_dir/trace.json` without blocking the
    caller (a live serving loop answering its exposition socket): a
    daemon thread starts the profiler, sleeps, stops it and writes the
    trace; this returns `{"status": "started"}` once the profiler runs.
    The profiler's state belongs to the thread that started it, so that
    thread also stops it; the CUDA kernels are traced device-wide, the
    CPU ops of that thread only. `gate` (a lock, or None) is held while
    the profiler starts and while it stops: a serving loop that holds
    the same lock across each tick launches no kernel and replays no
    CUDA graph while the tracer turns on or off. Degrades to a
    structured answer — never an exception — when the profiler cannot
    start (`"unsupported"`) or a trace is already running (`"busy"`)."""
    seconds = max(0.1, min(float(seconds), 600.0))
    out = str(out_dir)
    with _TRACE_LOCK:
        if _TRACE_ACTIVE:
            return {"status": "busy", "dir": _TRACE_ACTIVE[0]}
        _TRACE_ACTIVE.append(out)
    started = threading.Event()
    outcome: dict = {}

    held = gate if gate is not None else contextlib.nullcontext()

    def _run():
        try:
            Path(out).mkdir(parents=True, exist_ok=True)
            prof = torch.profiler.profile(activities=_activities())
            with held:
                prof.start()
        except Exception as e:  # noqa: BLE001 — answer, don't raise
            outcome["error"] = repr(e)[:300]
            with _TRACE_LOCK:
                _TRACE_ACTIVE.clear()
            started.set()
            return
        started.set()
        time.sleep(seconds)
        try:
            with held:
                prof.stop()
            prof.export_chrome_trace(str(Path(out) / TRACE_NAME))
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        finally:
            with _TRACE_LOCK:
                _TRACE_ACTIVE.clear()

    threading.Thread(target=_run, name="on-demand-trace",
                     daemon=True).start()
    started.wait()
    if "error" in outcome:
        return {"status": "unsupported", "error": outcome["error"]}
    return {"status": "started", "dir": out, "seconds": seconds}
