"""Deterministic fault-injection harness (testing/chaos.py).

In-tree rather than under tests/ because the chaos hooks are part of
the shipped CLI surface (`hyperion ... --chaos`): the same fault plans
that drive the tier-1 integration tests can be pointed at a real TPU
run to rehearse preemption/corruption recovery before trusting it.
"""
