"""Serving: paged KV blocks, admission queue, continuous-batching
engine, the JSONL front end with its unix-socket transport, the client,
the load generator and the replica-tier router.

The serve host stack's public names below load on first use, so
importing the router or the client loads no torch."""

from __future__ import annotations

import importlib

_LAZY = {
    "serve_socket": "server",
    "prepare_socket_path": "server", "maybe_resume_doc": "server",
    "resume_sink": "server", "submit_resume": "server",
    "ServeClient": "client", "StreamInterrupted": "client",
    "TERMINAL_EVENTS": "client",
    "LoadSpec": "loadgen", "build_workload": "loadgen",
    "run_load": "loadgen", "run_load_socket": "loadgen",
    "SERVING_REPORT_KEYS": "loadgen",
    "ReplicaHandle": "replica",
    "RouterJournal": "router_journal", "OrphanedDispatch": "router_journal",
    "Router": "router", "RouterPolicy": "router", "StreamDedup": "router",
    "FleetActions": "router",
    "RouterMetrics": "metrics",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
