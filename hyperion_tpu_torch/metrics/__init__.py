"""Per-epoch CSV metrics."""
