"""The port's host-only watchdog and input halves against the reference:
`obs/health.py` (`HealthMonitor`: the same scalar stream gives the same
anomalies and actions in both packages), `data/prefetch.py`
(`Prefetcher`), the registry's trainer gauges and `mfu_value` against
`hyperion_tpu/obs/registry.py`'s on the same inputs, the H100 entry of
`utils/chips.py`, and `compiled_flops` (one step's products counted on
a meta twin) against the closed form of the models' products. The
cases of `tests/test_health.py` and `tests/test_prefetch.py` run on
the port's classes.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from hyperion_tpu.obs import health as jax_health
from hyperion_tpu.obs import registry as jax_registry
from hyperion_tpu_torch.data.prefetch import Prefetcher
from hyperion_tpu_torch.data.sharding import ShardedBatches
from hyperion_tpu_torch.data.text import synthetic_lm_split
from hyperion_tpu_torch.obs import registry
from hyperion_tpu_torch.obs.health import (
    ACTIONS,
    HealthConfig,
    HealthMonitor,
    worst,
)
from hyperion_tpu_torch.obs.trace import Tracer
from hyperion_tpu_torch.utils import chips


class TestHealthMonitor:
    def test_quiet_run_stays_quiet(self):
        mon = HealthMonitor(HealthConfig(policy="abort"))
        for i in range(100):
            assert mon.observe_step(i, loss=4.0 - i * 0.01, grad_norm=1.0,
                                    step_time_s=0.01) == "none"
        assert mon.anomalies == []

    @pytest.mark.parametrize("bad", [float("nan"), float("inf"),
                                     float("-inf")])
    def test_nonfinite_loss_is_fatal(self, bad):
        mon = HealthMonitor(HealthConfig(policy="abort"))
        assert mon.observe_step(0, loss=4.0) == "none"
        assert mon.observe_step(1, loss=bad) == "abort"
        (anom,) = mon.anomalies
        assert anom.kind == "nonfinite_loss" and anom.fatal

    def test_nonfinite_grad_is_fatal(self):
        mon = HealthMonitor(HealthConfig(policy="abort"))
        assert mon.observe_step(0, grad_norm=float("nan")) == "abort"
        assert mon.anomalies[0].kind == "nonfinite_grad"

    def test_policy_caps_fatal_action(self):
        for policy, expect in [("warn", "warn"), ("checkpoint", "checkpoint"),
                               ("abort", "abort")]:
            mon = HealthMonitor(HealthConfig(policy=policy))
            assert mon.observe_step(0, loss=float("nan")) == expect
        assert HealthMonitor(HealthConfig(policy="off")).observe_step(
            0, loss=float("nan")) == "none"

    def test_loss_spike_z_score(self):
        cfg = HealthConfig(policy="abort", min_window=8)
        mon = HealthMonitor(cfg)
        rng = np.random.default_rng(0)
        for i in range(32):  # noisy but sane window
            assert mon.observe_step(
                i, loss=4.0 + 0.05 * float(rng.standard_normal())) == "none"
        # a 100x jump is a spike; statistical anomalies cap below abort
        action = mon.observe_step(32, loss=400.0)
        assert action == "checkpoint"  # capped: never aborts on a spike
        assert mon.anomalies[-1].kind == "loss_spike"
        assert not mon.anomalies[-1].fatal

    def test_spike_on_flat_window_uses_relative_jump(self):
        mon = HealthMonitor(HealthConfig(policy="warn", min_window=4))
        for i in range(8):
            mon.observe_step(i, loss=1.0)  # zero-variance window
        assert mon.observe_step(8, loss=50.0) == "warn"
        assert mon.anomalies[-1].kind == "loss_spike"

    def test_grad_explosion(self):
        mon = HealthMonitor(HealthConfig(policy="warn", min_window=4))
        for i in range(16):
            assert mon.observe_step(i, grad_norm=1.0 + 0.01 * i) == "none"
        assert mon.observe_step(16, grad_norm=100.0) == "warn"
        assert mon.anomalies[-1].kind == "grad_explosion"

    def test_step_stall_vs_ema(self):
        mon = HealthMonitor(HealthConfig(policy="warn", min_window=4))
        for i in range(16):
            assert mon.observe_step(i, step_time_s=0.01) == "none"
        assert mon.observe_step(16, step_time_s=1.0) == "warn"
        assert mon.anomalies[-1].kind == "step_stall"

    def test_step_stall_caps_at_warn_even_under_checkpoint_policy(self):
        # step time is the one HOST-LOCAL signal (loss/grads are
        # replicated): a stall must never trigger the barrier-fenced
        # checkpoint path, or one host of a multi-host run enters the
        # barrier while its peers keep training
        mon = HealthMonitor(HealthConfig(policy="checkpoint",
                                         min_window=4))
        for i in range(16):
            mon.observe_step(i, step_time_s=0.01)
        assert mon.observe_step(16, step_time_s=1.0) == "warn"

    def test_cofired_fatal_and_stall_expose_the_fatal(self):
        # one step can fire a non-fatal stall AND a fatal NaN together;
        # last_escalated carries the whole batch so a caller gating a
        # checkpoint on "not fatal" cannot be fooled by anomalies[-1]
        mon = HealthMonitor(HealthConfig(policy="checkpoint",
                                         min_window=2))
        for i in range(8):
            mon.observe_step(i, loss=1.0, step_time_s=0.01)
        action = mon.observe_step(8, loss=float("nan"), step_time_s=1.0)
        assert action == "checkpoint"  # fatal capped by the policy
        kinds = {a.kind for a in mon.last_escalated}
        assert kinds == {"nonfinite_loss", "step_stall"}
        assert any(a.fatal for a in mon.last_escalated)

    def test_cooldown_rate_limits_repeats(self):
        mon = HealthMonitor(HealthConfig(policy="warn", cooldown_steps=10))
        assert mon.observe_step(0, loss=float("nan")) == "warn"
        # a NaN-every-step run must not log one event per step
        for i in range(1, 10):
            assert mon.observe_step(i, loss=float("nan")) == "none"
        assert mon.observe_step(10, loss=float("nan")) == "warn"
        assert len(mon.anomalies) == 2

    def test_events_land_in_trace_with_anomaly_field(self, tmp_path):
        t = Tracer(tmp_path / "t.jsonl", run="r", proc=0)
        mon = HealthMonitor(HealthConfig(policy="abort"), tracer=t)
        mon.observe_step(7, loss=float("nan"))
        t.close()
        (rec,) = [json.loads(line)
                  for line in (tmp_path / "t.jsonl").read_text().splitlines()]
        assert rec["kind"] == "event" and rec["name"] == "health"
        # "kind" is a reserved tracer key — the anomaly class must
        # survive under its own field
        assert rec["anomaly"] == "nonfinite_loss"
        assert rec["step"] == 7 and rec["fatal"] is True
        assert rec["action"] == "abort"

    def test_epoch_granularity_check(self):
        mon = HealthMonitor(HealthConfig(policy="abort"))
        assert mon.observe_epoch(1, 100, 4.0) == "none"
        assert mon.observe_epoch(2, 200, float("nan")) == "abort"

    def test_summary_tallies(self):
        mon = HealthMonitor(HealthConfig(policy="warn", cooldown_steps=1))
        mon.observe_step(0, loss=float("nan"))
        mon.observe_step(1, loss=float("nan"))
        s = mon.summary()
        assert s["anomalies"] == {"nonfinite_loss": 2}
        assert s["fatal"] == 2 and s["steps_observed"] == 2

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError, match="policy"):
            HealthConfig(policy="explode")

    def test_worst_ordering(self):
        assert worst("none", "warn") == "warn"
        assert worst("abort", "checkpoint") == "abort"
        assert list(ACTIONS) == ["none", "warn", "checkpoint", "abort"]


class TestPrefetcherUnit:
    def test_forwards_items_in_order(self):
        assert list(Prefetcher(iter(range(50)), depth=3)) == list(range(50))

    def test_depth_zero_is_threadless_passthrough(self):
        p = Prefetcher(iter(range(5)), depth=0)
        assert p._thread is None  # the one-switch sync fallback
        assert list(p) == list(range(5))
        assert p.wait_s >= 0.0  # the sync path is still timed

    def test_none_is_a_legal_item(self):
        assert list(Prefetcher(iter([None, 1, None]), depth=2)) == \
            [None, 1, None]

    def test_worker_exception_propagates_after_queued_items(self):
        """A fault mid-stream must surface in the CONSUMER thread, at
        the point the failed batch would have arrived — never die
        silently in the worker."""

        def gen():
            yield 1
            yield 2
            raise OSError("storage blip in the worker")

        got = []
        with pytest.raises(OSError, match="storage blip"):
            for x in Prefetcher(gen(), depth=1):
                got.append(x)
        assert got == [1, 2]

    def test_close_unblocks_a_worker_stuck_on_a_full_queue(self):
        produced = []

        def gen():
            for i in range(100_000):
                produced.append(i)
                yield i

        p = Prefetcher(gen(), depth=2)
        assert next(p) == 0
        deadline = time.monotonic() + 5.0
        while len(produced) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)  # let the worker fill the queue and block
        p.close()
        assert not p._thread.is_alive()
        assert len(produced) < 100_000  # stopped mid-stream, not drained
        p.close()  # idempotent

    def test_wait_s_accumulates_when_producer_is_slow(self):
        def slow_gen():
            for i in range(3):
                time.sleep(0.02)
                yield i

        p = Prefetcher(slow_gen(), depth=2)
        assert list(p) == [0, 1, 2]
        assert p.wait_s > 0.0

    def test_chaos_data_iter_fault_reaches_the_main_thread(self):
        """The `fault_point("data_iter")` seam fires inside the WORKER
        once host batches assemble ahead — the injected OSError must
        still reach the consuming loop."""
        from hyperion_tpu_torch.testing import chaos
        from hyperion_tpu_torch.utils import retry as retry_mod

        split = synthetic_lm_split(64, seq_len=8, seed=0)
        batches = ShardedBatches(split.arrays(), 16, "cpu", seed=0)
        plan = chaos.ChaosPlan(chaos.parse_plan("io_fail@p=1"))
        retry_mod.set_fault_injector(plan.io_fail)
        try:
            with pytest.raises(OSError, match="injected io_fail"):
                with Prefetcher(batches.host_epoch(0), depth=2) as feed:
                    list(feed)
        finally:
            retry_mod.set_fault_injector(None)

    @pytest.mark.parametrize("start", [0, 1])
    def test_prefetched_epoch_identical_to_sync(self, start):
        """Same seeded permutation, batch for batch: `host_epoch` on the
        worker and `to_device` on the consumer equal `epoch`."""
        split = synthetic_lm_split(48, seq_len=8, seed=3)
        batches = ShardedBatches(split.arrays(), 16, "cpu", seed=7)
        sync = [b["input_ids"] for b in batches.epoch(2, start)]
        with Prefetcher(batches.host_epoch(2, start), depth=3) as feed:
            prefetched = [batches.to_device(b)["input_ids"] for b in feed]
        assert len(sync) == len(prefetched) == 3 - start
        for a, b in zip(sync, prefetched):
            assert torch.equal(a, b)


# ------------------------------------------------ against the reference


def _stream(seed: int, n: int = 400):
    """A scalar stream with every anomaly kind in it: noisy losses with
    a spike and a NaN, grad norms with an explosion and an inf, step
    times with a stall."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        loss = 4.0 - i * 0.002 + 0.05 * float(rng.standard_normal())
        grad = 1.0 + 0.1 * float(rng.random())
        dt = 0.01 + 0.001 * float(rng.random())
        if i in (60, 250):
            loss *= 40
        if i in (90, 300):
            grad *= 200
        if i in (120, 330):
            dt *= 50
        if i == 200:
            loss = float("nan")
        if i == 380:
            grad = float("inf")
        out.append((i, None if i % 97 == 5 else loss,
                    None if i % 89 == 7 else grad, dt))
    return out


@pytest.mark.parametrize("policy", ["off", "warn", "checkpoint", "abort"])
@pytest.mark.parametrize("seed", [0, 1])
def test_same_stream_same_anomalies_and_actions(policy, seed, tmp_path):
    kw = dict(policy=policy, min_window=8, cooldown_steps=20)
    mons = [jax_health.HealthMonitor(jax_health.HealthConfig(**kw)),
            HealthMonitor(HealthConfig(**kw))]
    acts = [[], []]
    for step, loss, grad, dt in _stream(seed):
        for k, mon in enumerate(mons):
            acts[k].append(mon.observe_step(step, loss=loss, grad_norm=grad,
                                            step_time_s=dt))
    for epoch, loss in enumerate([5.0, 4.0, float("nan"), 3.5]):
        for k, mon in enumerate(mons):
            acts[k].append(mon.observe_epoch(epoch + 1, 400 + epoch, loss))
    assert acts[0] == acts[1]
    key = [[(a.kind, a.step, a.fatal, a.action_cap,
             repr(a.value), a.detail) for a in m.anomalies] for m in mons]
    assert key[0] == key[1]
    assert mons[0].summary() == mons[1].summary()
    if policy != "off":
        assert {a[0] for a in key[1]} >= {"loss_spike", "grad_explosion",
                                          "step_stall", "nonfinite_loss",
                                          "nonfinite_grad"}


def test_gauges_match_the_reference_registry():
    """The trainer's per-epoch gauges, fed the same numbers in both
    packages, snapshot the same (the device-memory gauge: None on the
    CPU in both)."""
    regs = (jax_registry.MetricsRegistry(), registry.MetricsRegistry())
    for mod, reg in zip((jax_registry, registry), regs):
        for i in range(5):
            mod.observe_step(reg, 0.01 + i * 1e-3, tokens=4096)
        mod.observe_throughput(reg, 1.5, 90, tokens=90 * 4096)
        mod.observe_input_wait(reg, 0.03, 1.5)
        mod.observe_device_memory(reg)
        mod.observe_mfu(reg, 3.6e11, 0.0134)
    a, b = (r.snapshot() for r in regs)
    assert a["counters"] == b["counters"]
    assert a["histograms"] == b["histograms"]
    for k in ("step_time_ema_ms", "step_time_fenced_ms", "tokens_per_s",
              "input_wait_s", "input_wait_frac", "hbm_live_mb",
              "hbm_peak_mb", "flops_per_step"):
        assert a["gauges"][k] == b["gauges"][k], k
    # the CPU's MFU is against each package's measured host matmul rate
    assert b["labels"]["mfu_peak_source"] == "measured_host"
    assert 0 < b["gauges"]["mfu"]


@pytest.mark.parametrize("flops, t, peak, n", [
    (3.6e11, 0.0134, 989.4, 1), (1.9e14, 0.41, 989.4, 1),
    (1.0e12, 0.5, 197.0, 4), (None, 0.1, 989.4, 1), (1e9, 0.0, 989.4, 1)])
def test_mfu_value_matches_the_reference(flops, t, peak, n):
    assert registry.mfu_value(flops, t, peak_tflops=peak, n_devices=n) == \
        jax_registry.mfu_value(flops, t, peak_tflops=peak, n_devices=n)


def test_h100_datasheet_peaks(monkeypatch):
    monkeypatch.setattr(chips, "device_kind",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert chips.nominal_peak_tflops("bfloat16") == 989.4
    assert chips.nominal_peak_tflops("tf32") == 494.7
    assert chips.nominal_peak_tflops("float32") == 66.9
    assert chips.mfu(494.7) == pytest.approx(0.5)
    assert registry.mfu_value(989.4e12 * 0.25, 1.0) == (
        pytest.approx(0.25), "nominal")
    monkeypatch.setattr(chips, "device_kind", lambda device=None: "cpu")
    assert chips.nominal_peak_tflops() is None


# --------------------------------------------------------- FLOP count


def _lm_closed_form(cfg, B: int, T: int) -> float:
    """One train step of the TransformerLM: forward products 2·tokens·
    (every projection's weights) plus QKᵀ and PV (2·2·B·T²·d a layer,
    unmasked, as the counters count them); backward twice the forward
    (dX and dW of each product)."""
    d, ff = cfg.d_model, cfg.ff_dim
    per_layer = 4 * d * d + 2 * d * ff
    fwd = 2 * B * T * (cfg.n_layers * per_layer + d * cfg.vocab_size) \
        + cfg.n_layers * 4 * B * T * T * d
    return 3.0 * fwd


def _llama_closed_form(cfg, B: int, T: int, remat: bool) -> float:
    """Full fine-tune of Llama: the same rule with GQA's k/v widths and
    SwiGLU's three products; under remat "full" the blocks' forward runs
    once more inside the backward, up to what the backward needs: the
    recompute stops before each block's last product (the down
    projection, whose output no gradient reads)."""
    d, ff, L = cfg.d_model, cfg.ff_dim, cfg.n_layers
    kv = cfg.n_kv_heads * (d // cfg.n_heads)
    block = 2 * B * T * (2 * d * d + 2 * d * kv + 3 * d * ff) \
        + 4 * B * T * T * d
    head = 2 * B * T * d * cfg.vocab_size
    recompute = block - 2 * B * T * ff * d if remat else 0
    return 3.0 * (L * block + head) + L * recompute


def _meta_loss(m, b):
    from hyperion_tpu_torch.train.losses import next_token_loss

    logits = m(b["input_ids"], padding_mask=b.get("attention_mask"))
    return next_token_loss(logits, b["input_ids"], b.get("attention_mask"))


def _batch(B, T, vocab):
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (B, T)), dtype=torch.int32)
    return {"input_ids": ids, "attention_mask": torch.ones(B, T,
                                                           dtype=torch.int8)}


@pytest.mark.parametrize("d, layers, T", [(64, 2, 32), (256, 2, 128)])
def test_lm_flops_equal_the_closed_form(d, layers, T):
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )

    cfg = simple_lm_config(d_model=d, n_heads=4, n_layers=layers,
                           ff_dim=4 * d, max_len=T, dropout=0.1,
                           norm_impl="pallas", attention_impl="pallas")
    model = TransformerLM(cfg, device="cpu")
    got = registry.compiled_flops(model, _meta_loss, _batch(4, T, 1000))
    assert got == _lm_closed_form(cfg, 4, T)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_llama_flops_equal_the_closed_form(remat):
    from hyperion_tpu_torch.models import llama as tl

    cfg = tl.llama_tiny_config(max_len=32, remat=remat,
                               attention_impl="pallas", norm_impl="pallas")
    model = tl.Llama(cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    got = registry.compiled_flops(model, _meta_loss, _batch(2, 32, 256))
    assert got == _llama_closed_form(cfg, 2, 32, remat == "full")


def test_lora_flops_skip_the_frozen_weight_gradients():
    """A frozen base runs no weight-gradient products: below twice the
    forward (its forward and input gradients), and above that less the
    first block's q/k/v input gradients (the frozen embedding's output
    needs none); the adapters' small products fill the gap."""
    from hyperion_tpu_torch.models import llama as tl

    base = tl.llama_tiny_config(max_len=32)
    lora = dataclasses.replace(base, lora_rank=4, lora_scale=2.0,
                               lora_targets=("q_proj", "v_proj"))
    model = tl.Llama(lora, device="cpu")
    for n, p in model.named_parameters():
        p.requires_grad_(n.endswith(("lora_a", "lora_b")))
    got = registry.compiled_flops(model, _meta_loss, _batch(2, 32, 256))
    fwd = _llama_closed_form(base, 2, 32, False) / 3
    d, kv = base.d_model, base.n_kv_heads * (base.d_model // base.n_heads)
    first_qkv_dx = 2 * 2 * 32 * (d * d + 2 * d * kv)
    assert 2 * fwd - first_qkv_dx < got < 2 * fwd


def test_flop_count_runs_no_kernel_and_touches_no_weight():
    from hyperion_tpu_torch.models.transformer_lm import (
        TransformerLM,
        simple_lm_config,
    )
    from hyperion_tpu_torch.ops import fused_ce, fused_norm

    cfg = simple_lm_config(d_model=32, n_heads=2, n_layers=1, ff_dim=64,
                           max_len=16, norm_impl="pallas")
    model = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = (fused_norm.fused_layernorm.launches,
                fused_ce.fused_softmax_xent_fwd.launches)
    assert registry.compiled_flops(model, _meta_loss, _batch(2, 16, 100))
    assert (fused_norm.fused_layernorm.launches,
            fused_ce.fused_softmax_xent_fwd.launches) == launches
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) and v.device.type == "cpu"
    assert all(p.grad is None for p in model.parameters())
