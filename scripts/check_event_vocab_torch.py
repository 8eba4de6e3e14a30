#!/usr/bin/env python
"""Telemetry event-vocabulary drift guard over the port's sources.

The port's serving producers (`hyperion_tpu_torch/serve/*.py`) emit
events by string literal at each `tracer.event("...")` call site, and
its offline consumers (`obs trace`: obs/timeline.py and
obs/fleet_trace.py; `obs doctor`: obs/doctor.py) match those names by
string literal too. A producer renamed or added without its consumers
drops out of every waterfall, fleet join and incident rule, and nothing
says so.

Every event name emitted under the port's serve/ must appear somewhere
in those consumer sources; an orphaned name fails with the file:line
of its call site.

    python scripts/check_event_vocab_torch.py

Exit 0: every emitted event is consumed. Exit 1: orphans named on
stderr. A source scan: it imports nothing of the package; tier-1 runs
it through tests/test_torch_surfaces.py.
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "hyperion_tpu_torch")

PRODUCER_DIR = os.path.join(PACKAGE, "serve")
CONSUMERS = tuple(os.path.join(PACKAGE, "obs", name)
                  for name in ("timeline.py", "fleet_trace.py", "doctor.py"))

# `.event("name"`, the name literal possibly wrapped onto the next line
_CALL = re.compile(r"\.event\(\s*\"([a-z0-9_]+)\"")


def emitted_events() -> dict[str, list[str]]:
    """Event name -> the `file:line` call sites under serve/."""
    out: dict[str, list[str]] = {}
    for fname in sorted(os.listdir(PRODUCER_DIR)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(PRODUCER_DIR, fname), encoding="utf-8") as f:
            text = f.read()
        for m in _CALL.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            out.setdefault(m.group(1), []).append(
                f"hyperion_tpu_torch/serve/{fname}:{line}")
    return out


def consumer_vocabulary() -> str:
    """The consumer sources together; a name is consumed when it
    appears anywhere in them (match rules, vocabulary tuples, incident
    messages)."""
    chunks = []
    for path in CONSUMERS:
        with open(path, encoding="utf-8") as f:
            chunks.append(f.read())
    return "\n".join(chunks)


def orphans() -> dict[str, list[str]]:
    vocab = consumer_vocabulary()
    return {name: sites for name, sites in sorted(emitted_events().items())
            if name not in vocab}


def main(argv: list[str] | None = None) -> int:
    bad = orphans()
    if bad:
        for name, sites in bad.items():
            print(f"check_event_vocab_torch: FAIL — event {name!r} emitted "
                  f"at {', '.join(sites)} but no consumer (obs/timeline.py, "
                  "obs/fleet_trace.py, obs/doctor.py) knows the name: add "
                  "it to the consumer vocabulary, or it vanishes from "
                  "every trace and diagnosis", file=sys.stderr)
        return 1
    print(f"check_event_vocab_torch: OK — {len(emitted_events())} event "
          "name(s) emitted under hyperion_tpu_torch/serve/, all present "
          "in the consumer vocabulary")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
