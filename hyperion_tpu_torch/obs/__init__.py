"""Observability: the metrics registry, tracer and heartbeat, and the
run-health tools (`obs doctor`, `summarize`, `diff`, `trace`, `top`)."""
