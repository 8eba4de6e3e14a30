"""In-band anomaly detection over metrics the step loop already has —
`hyperion_tpu/obs/health.py`, host-only, copied.

Telemetry records faithfully but judges nothing; `HealthMonitor` is
the judge: fed the scalars each step
already returns (loss, `grad_norm` from `train/step.py`) plus the
host-side step duration the tracer already measured, it detects

  * non-finite loss / grad norm          (fatal — the run is poisoned)
  * loss spikes     — z-score over a rolling window of recent losses
  * grad explosions — grad_norm far above the rolling median
  * step-time stalls — a step far above the step-time EMA

Every detection is emitted as a `health` event into the telemetry
stream (so `obs doctor` can post-mortem it) and folded into an action
for the caller: ``none`` / ``warn`` / ``checkpoint`` / ``abort`` per a
configurable policy.

Sync discipline (the acceptance bar): the monitor consumes PYTHON
FLOATS only. It never touches a tensor, so it cannot add a device
sync — the trainer feeds it per-step values only where the step loop
already waits for every step (the CPU), and epoch-level values on the
card, from the epoch mean the CSV row already fetched. All window math
is O(window) host float ops per observation (window <= 64 by default)
— noise next to a training step.
"""

from __future__ import annotations

import collections
import dataclasses
import math

# escalation ladder; `worst` below relies on this order
ACTIONS = ("none", "warn", "checkpoint", "abort")

FATAL_KINDS = ("nonfinite_loss", "nonfinite_grad")
WARN_KINDS = ("loss_spike", "grad_explosion", "step_stall")


def worst(a: str, b: str) -> str:
    return a if ACTIONS.index(a) >= ACTIONS.index(b) else b


@dataclasses.dataclass
class HealthConfig:
    """Detection thresholds + the escalation policy.

    `policy` CAPS the action any anomaly can demand. Fatal anomalies
    (non-finite loss/grads) demand up to `abort`; statistical ones
    (spikes, explosions) cap at `checkpoint`; step stalls cap at `warn`
    (host-local signal — see Anomaly.action_cap). Note the asymmetry a
    caller must honor: a `checkpoint` action for a FATAL anomaly must
    NOT save state (the tree already took the non-finite update —
    trainer._health_react enforces this); only `abort` prevents a
    diverged run from training on to a poisoned final export."""

    policy: str = "warn"        # off | warn | checkpoint | abort
    window: int = 64            # rolling window for loss z / grad median
    min_window: int = 16        # observations before statistical detectors arm
    loss_z: float = 6.0         # spike: |loss - mean| > z * std
    grad_ratio: float = 10.0    # explosion: grad_norm > ratio * rolling median
    stall_ratio: float = 10.0   # stall: step_time > ratio * EMA
    stall_ema_alpha: float = 0.1
    cooldown_steps: int = 50    # per-kind event/escalation rate limit

    def __post_init__(self):
        if self.policy not in ("off", *ACTIONS):
            raise ValueError(
                f"health policy {self.policy!r} not in off/{'/'.join(ACTIONS)}"
            )


@dataclasses.dataclass
class Anomaly:
    kind: str
    step: int
    value: float
    detail: dict
    fatal: bool

    @property
    def action_cap(self) -> str:
        # Statistical detectors cap at "checkpoint": evidence-preserving,
        # never run-killing. step_stall caps at "warn" on top of that:
        # it is the one detector fed by a HOST-LOCAL signal (this
        # host's wall-clock step time — loss/grad metrics are
        # replicated), so letting it trigger a barrier-fenced
        # checkpoint would send one host of a multi-host run into
        # _save_checkpoint while its peers keep training.
        if self.fatal:
            return "abort"
        return "warn" if self.kind == "step_stall" else "checkpoint"


class HealthMonitor:
    """Feed it host scalars; it feeds the trace and tells you how loudly
    to react. `observe_step` returns the strongest action the policy
    demands for this step's anomalies ("none" when quiet)."""

    def __init__(self, cfg: HealthConfig | None = None, tracer=None):
        self.cfg = cfg or HealthConfig()
        self.tracer = tracer
        self.anomalies: list[Anomaly] = []
        # anomalies that escaped the cooldown in the MOST RECENT
        # observe call — what a caller reacting to the returned action
        # must inspect (a step can fire a fatal NaN and a non-fatal
        # stall together; anomalies[-1] alone would name the wrong one)
        self.last_escalated: list[Anomaly] = []
        self._losses: collections.deque = collections.deque(
            maxlen=self.cfg.window)
        self._grads: collections.deque = collections.deque(
            maxlen=self.cfg.window)
        self._step_ema: float | None = None
        self._n_steps = 0
        self._last_fired: dict[str, int] = {}  # kind -> step (cooldown)

    # ---------------------------------------------------------- detectors

    def observe_step(
        self,
        step: int,
        loss: float | None = None,
        grad_norm: float | None = None,
        step_time_s: float | None = None,
    ) -> str:
        if self.cfg.policy == "off":
            return "none"
        self._n_steps += 1
        found: list[Anomaly] = []
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                found.append(Anomaly("nonfinite_loss", step, loss, {}, True))
            else:
                z = self._loss_z(loss)
                if z is not None and z > self.cfg.loss_z:
                    found.append(Anomaly(
                        "loss_spike", step, loss,
                        {"z": round(z, 2),
                         "window_mean": round(self._mean(self._losses), 4)},
                        False,
                    ))
                self._losses.append(loss)
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            if not math.isfinite(grad_norm):
                found.append(Anomaly(
                    "nonfinite_grad", step, grad_norm, {}, True))
            else:
                med = self._median(self._grads)
                if (med is not None and med > 0
                        and len(self._grads) >= self.cfg.min_window
                        and grad_norm > self.cfg.grad_ratio * med):
                    found.append(Anomaly(
                        "grad_explosion", step, grad_norm,
                        {"rolling_median": round(med, 6),
                         "ratio": round(grad_norm / med, 2)},
                        False,
                    ))
                self._grads.append(grad_norm)
        if step_time_s is not None and step_time_s > 0:
            ema = self._step_ema
            if (ema is not None and self._n_steps > self.cfg.min_window
                    and step_time_s > self.cfg.stall_ratio * ema):
                found.append(Anomaly(
                    "step_stall", step, step_time_s,
                    {"ema_s": round(ema, 6),
                     "ratio": round(step_time_s / ema, 2)},
                    False,
                ))
            a = self.cfg.stall_ema_alpha
            self._step_ema = (
                step_time_s if ema is None else a * step_time_s + (1 - a) * ema
            )
        return self._escalate(found)

    def observe_epoch(self, epoch: int, step: int, loss: float) -> str:
        """Epoch-granularity check for backends where per-step scalars
        stay on device: a NaN anywhere in the epoch poisons the epoch
        mean, so non-finite divergence is still caught — one epoch late
        at worst, with zero added fetches (the mean was already
        fetched for the CSV row)."""
        if self.cfg.policy == "off":
            return "none"
        loss = float(loss)
        found: list[Anomaly] = []
        if not math.isfinite(loss):
            found.append(Anomaly(
                "nonfinite_loss", step, loss, {"epoch": epoch}, True))
        else:
            z = self._loss_z(loss)
            if z is not None and z > self.cfg.loss_z:
                found.append(Anomaly(
                    "loss_spike", step, loss,
                    {"epoch": epoch, "z": round(z, 2)}, False))
            self._losses.append(loss)
        return self._escalate(found)

    # ----------------------------------------------------------- plumbing

    def _escalate(self, found: list[Anomaly]) -> str:
        action = "none"
        self.last_escalated = []
        for anom in found:
            last = self._last_fired.get(anom.kind)
            if last is not None and anom.step - last < self.cfg.cooldown_steps:
                continue  # a NaN-every-step run logs one event per cooldown
            self._last_fired[anom.kind] = anom.step
            self.anomalies.append(anom)
            self.last_escalated.append(anom)
            demanded = min(anom.action_cap, self.cfg.policy, key=ACTIONS.index)
            if self.tracer is not None:
                # NB: "kind" is a reserved tracer record key (it is
                # "event" here); the anomaly class rides as "anomaly"
                self.tracer.event(
                    "health", step=anom.step, anomaly=anom.kind,
                    value=(anom.value if math.isfinite(anom.value)
                           else repr(anom.value)),
                    fatal=anom.fatal, action=demanded, **anom.detail,
                )
            action = worst(action, demanded)
        return action

    def _loss_z(self, loss: float) -> float | None:
        if len(self._losses) < self.cfg.min_window:
            return None
        mean = self._mean(self._losses)
        var = sum((x - mean) ** 2 for x in self._losses) / len(self._losses)
        std = math.sqrt(var)
        if std <= 1e-12:
            # a flat window (converged / synthetic): fall back to a
            # relative jump so true spikes off a flat line still fire
            return abs(loss - mean) / max(abs(mean), 1e-12) * self.cfg.loss_z
        return abs(loss - mean) / std

    @staticmethod
    def _mean(xs) -> float:
        return sum(xs) / len(xs)

    @staticmethod
    def _median(xs) -> float | None:
        if not xs:
            return None
        s = sorted(xs)
        return s[len(s) // 2]

    def summary(self) -> dict:
        by_kind: dict[str, int] = {}
        for a in self.anomalies:
            by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
        return {
            "anomalies": by_kind,
            "fatal": sum(1 for a in self.anomalies if a.fatal),
            "steps_observed": self._n_steps,
        }
