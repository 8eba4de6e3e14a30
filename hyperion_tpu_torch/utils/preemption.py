"""Graceful-preemption guard: latch SIGTERM/SIGINT, exit at a step boundary
— `hyperion_tpu/utils/preemption.py`, host-only, copied.

Accelerator capacity is routinely preemptible. Killing a training
process mid-step loses everything since the last epoch save; with
hour-long epochs that is an hour of device time per preemption.

`PreemptionGuard` installs handlers that *latch a flag* instead of
dying; the epoch loop checks `guard.triggered` at every step boundary,
saves a mid-epoch checkpoint, and exits cleanly — and the trainers
resume *within* the interrupted epoch (`ShardedBatches.epoch(...,
start_step=...)` skips the already-trained prefix of the same seeded
permutation, so no batch is trained twice and none is skipped).

A second signal restores the previous handler and re-raises, so an
impatient operator's second Ctrl-C (or the platform's escalation to
SIGKILL semantics) still kills promptly rather than appearing ignored.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager latching SIGTERM/SIGINT into a step-boundary flag.

    Signal handlers only install in the main thread (Python restricts
    `signal.signal` to it); elsewhere the guard degrades to an inert
    flag — `trigger()` still works, so tests and schedulers can request
    a graceful stop programmatically from any thread.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, on_latch=None) -> None:
        self._event = threading.Event()
        self._prev: dict[int, object] = {}
        # observer called ONCE, from the handler, when the first signal
        # latches: the epoch loop points it at the trace/heartbeat so a
        # preemption is on disk the moment it lands — if the grace
        # window expires during the checkpoint save that follows, the
        # post-mortem still shows "signal latched at step N", not an
        # unprovoked crash. Exceptions are swallowed: observability must
        # never break the graceful-exit path it observes.
        self.on_latch = on_latch

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Programmatic graceful-stop request (what a signal does)."""
        self._event.set()

    def _handle(self, signum, frame):
        if self._event.is_set():
            # second signal: hand back to the previous handler so the
            # process actually dies instead of looking hung
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            raise KeyboardInterrupt(f"second signal {signum} during shutdown")
        self._event.set()
        if self.on_latch is not None:
            try:
                self.on_latch(signum)
            except Exception:  # noqa: BLE001 — see __init__
                pass
        print(f"[preemption] caught signal {signum}; finishing current step, "
              "then checkpointing and exiting (send again to kill now)")

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
