#!/usr/bin/env python
"""Diff-gate drift guard over the port's sources.

The port's `obs diff` gates the metric names in
`hyperion_tpu_torch/obs/diff.py:METRICS`, and every one of them must be
producible from something an emitter writes: a bench headline line,
its `serving`/`serving_scale`/`input_pipeline`/`decode_attention`/
`fleet_sim` rows, a trainer summary, or `obs summarize --json`. A gate
whose emitter key was renamed drops out of every diff table, and the
regression it was meant to catch passes as "nothing comparable".

This guard feeds the port's `normalize()` one synthetic document that
carries every emitter surface in the port's own vocabularies (the
serving row from `serve/loadgen.py` SERVING_REPORT_KEYS, the fleet
simulator's row from `serve/simulate.py` DIFF_GATED) and fails when a
gated name is not produced (an orphaned gate), when a zero-pinned name
is not gated, or when a key that `serve/simulate.py` DIFF_GATED,
`serve/hostcache.py` TIER_GATED or the decode-attention row promises is
not gated.

    python scripts/check_diff_gates_torch.py

Exit 0: every gate reachable. Exit 1: the faults named on stderr.
Host-only imports (no torch, no devices); tier-1 runs it through
tests/test_torch_surfaces.py.
"""

from __future__ import annotations

import os
import sys

# run from anywhere: scripts/, not the repo root, is sys.path[0]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hyperion_tpu_torch.obs.diff import METRICS, ZERO_PINNED, normalize
from hyperion_tpu_torch.serve.hostcache import ungated_tier_keys
from hyperion_tpu_torch.serve.loadgen import SERVING_REPORT_KEYS
from hyperion_tpu_torch.serve.simulate import DIFF_GATED, diff_key

# The serving_scale and decode_attention rows are written by a bench
# harness; the port has none yet (its benchmark comes in a PR of its
# own), and `obs diff` reads the rows in the format the reference's
# bench.py writes them (`_child_serving_scale`, DECODE_ATTN_REPORT_KEYS).
# Their keys are mirrored here, so a rename on the gate side orphans the
# gate loudly.
SERVING_SCALE_KEYS = ("tokens_per_s", "scaleup", "fairness",
                      "affinity_hit_rate", "duplicate_tokens",
                      "router_overhead_p99_ms", "failover_gap_p99_ms")
DECODE_ATTN_KEYS = ("decode_attn_tokens_per_s",
                    "decode_attn_gather_tokens_per_s",
                    "decode_attn_recompiles")


def synthetic_doc() -> dict:
    """One document exercising every `normalize()` surface with the
    keys the emitters write."""
    return {
        # obs summarize --json
        "step_time_ms": {"p50": 1.0, "p99": 1.0, "mean": 1.0},
        "tokens_per_s": 1.0, "samples_per_s": 1.0, "mfu": 1.0,
        "hbm_peak_mb": 1.0, "vs_baseline": 1.0,
        # a bench headline line and its probe rows
        "metric": "synthetic", "value": 1.0,
        "extra": {"lm_step_ms": 1.0, "lm_tokens_per_s": 1.0},
        "input_pipeline": {"sync_batches_per_s": 1.0,
                           "prefetch_batches_per_s": 1.0},
        "serving": {k: 1.0 for k in SERVING_REPORT_KEYS},
        "serving_scale": {k: 1.0 for k in SERVING_SCALE_KEYS},
        # the fleet simulator's row, from its own gate vocabulary
        "fleet_sim": {diff_key(scn, k): 1.0
                      for scn, keys in DIFF_GATED.items()
                      for k in keys},
        "decode_attention": {k: 1.0 for k in DECODE_ATTN_KEYS},
        # a trainer's *_summary.json
        "step_ms": 1.0, "peak_hbm_mb": 1.0,
    }


def orphaned_gates() -> list[str]:
    """Gated names `normalize()` cannot produce from any emitter
    vocabulary (sorted; empty = healthy)."""
    producible = set(normalize(synthetic_doc()))
    return sorted(set(METRICS) - producible)


def ungated_sim_keys() -> list[str]:
    """simulate.DIFF_GATED names missing from METRICS (sorted)."""
    promised = {diff_key(scn, k)
                for scn, keys in DIFF_GATED.items() for k in keys}
    return sorted(promised - set(METRICS))


def main(argv: list[str] | None = None) -> int:
    faults = {
        "simulate.DIFF_GATED name(s) not gated in obs/diff.py METRICS":
            ungated_sim_keys(),
        "hostcache.TIER_GATED name(s) not gated in obs/diff.py METRICS":
            ungated_tier_keys(METRICS),
        "decode-attention row key(s) not gated in obs/diff.py METRICS":
            sorted(set(DECODE_ATTN_KEYS) - set(METRICS)),
        "gated but unproducible metric(s) (the emitter key was renamed "
        "or never wired into obs/diff.py normalize())": orphaned_gates(),
        "ZERO_PINNED name(s) not in METRICS":
            sorted(set(ZERO_PINNED) - set(METRICS)),
    }
    for what, names in faults.items():
        if names:
            print(f"check_diff_gates_torch: FAIL — {what}: "
                  f"{', '.join(names)}", file=sys.stderr)
    if any(faults.values()):
        return 1
    print(f"check_diff_gates_torch: OK — {len(METRICS)} gated metric(s), "
          "all producible from the port's emitter vocabularies")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
