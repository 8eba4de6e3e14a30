"""Shared helpers for the benchmark suite — `hyperion_tpu/bench/util.py`."""

from __future__ import annotations

import csv
from pathlib import Path


def write_csv(path: Path | str, rows: list[dict]) -> None:
    """Write dict rows, creating parents; no-op on empty.

    Fieldnames are the first-seen-order union over all rows (an error
    row may add a column such as "note" that ok rows lack); missing keys
    render as "". Callers flush after every appended row, so a run cut
    at its time limit still leaves the measured rows on disk.
    """
    if not rows:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fields: list[str] = []
    for r in rows:
        fields.extend(k for k in r if k not in fields)
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)
