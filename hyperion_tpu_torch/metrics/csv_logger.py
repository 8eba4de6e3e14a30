"""Per-epoch CSV metrics — `hyperion_tpu/metrics/csv_logger.py:24-80`.

Same schemas, run ids (`{job}_{n}gpus_{YYYYmmdd_HHMMSS}`), file layout
(`{base_dir}/distributed/{run_id}_metrics.csv`) and number format as the
reference, so its report tooling reads either package's CSVs. The port
runs one process, so the logger is always the primary's.
"""

from __future__ import annotations

import csv
import datetime
from pathlib import Path

SCHEMAS: dict[str, tuple[str, ...]] = {
    "language_ddp": ("epoch", "loss", "duration_s", "gpus"),
    "language_fsdp": ("epoch", "loss", "duration_s", "gpus"),
    "cifar_ddp": ("epoch", "loss", "accuracy", "duration_s", "gpus"),
    "llama": ("epoch", "loss", "duration_s", "gpus", "mode"),
}


def run_id(job: str, n_devices: int,
           when: datetime.datetime | None = None) -> str:
    """`{job}_{n}gpus_{YYYYmmdd_HHMMSS}`."""
    when = when or datetime.datetime.now()
    return f"{job}_{n_devices}gpus_{when:%Y%m%d_%H%M%S}"


class CsvLogger:
    """Append-per-epoch CSV writer; the header is written at creation."""

    def __init__(self, job: str, n_devices: int,
                 base_dir: str | Path = "data",
                 schema: tuple[str, ...] | None = None,
                 run: str | None = None):
        self.job = job
        self.schema = schema or SCHEMAS.get(job)
        if self.schema is None:
            raise ValueError(f"no schema for job {job!r}; pass schema=")
        self.run = run or run_id(job, n_devices)
        self.path = Path(base_dir) / "distributed" / f"{self.run}_metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("w", newline="") as f:
            csv.writer(f).writerow(self.schema)

    def log(self, **row) -> None:
        missing = set(self.schema) - row.keys()
        if missing:
            raise ValueError(f"row missing columns {sorted(missing)}")
        with self.path.open("a", newline="") as f:
            csv.writer(f).writerow([_fmt(row[c]) for c in self.schema])

    def read(self) -> list[dict]:
        with self.path.open() as f:
            return list(csv.DictReader(f))


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(v)
