"""`obs top <dir>` — live fleet dashboard over exposition sockets; a copy
of `hyperion_tpu/obs/top.py` in the port, polling the port's sockets
(`obs/export.py`).

`obs doctor` reads artifacts after the fact; `obs top` asks the fleet
what it is doing RIGHT NOW. Given a run directory (a single serve/train
process) or a router base dir (`replica_<i>/` children next to the
router's own stream — the fleet layout), each refresh polls every
process's exposition socket (obs/export.py) and renders one row per
process: state, phase, occupancy, queue depth, windowed tokens/s,
windowed TTFT p99, KV blocks in use, brownout flag, firing alerts. A
process that does not answer its socket degrades to its heartbeat file
— last known phase/occupancy plus the beat age that says HOW dead it
is — so a crashed replica stays on the board as evidence instead of
vanishing from it.

Curses-free by design: the live view repaints with two ANSI escapes
(home + clear) so it works in any terminal, a tmux pane, or a
`script(1)` capture; `--once` prints a single frame, and
`--once --json` emits the machine-readable row list (stable keys) for
scripts and CI probes. Host-only file/socket IO — no torch import, no
devices, safe to run against a fleet mid-flight.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from hyperion_tpu_torch.obs.export import (
    DEFAULT_WINDOW_S,
    OBS_SOCKET_NAME,
    read_exposition,
)
from hyperion_tpu_torch.obs.heartbeat import heartbeat_age_s, read_heartbeat

DEFAULT_STALE_S = 30.0
DEFAULT_INTERVAL_S = 2.0

_ANSI_HOME_CLEAR = "\x1b[H\x1b[2J"
_STATE_COLORS = {"live": "\x1b[32m", "beating": "\x1b[33m",
                 "dead": "\x1b[31m", "done": "\x1b[2m",
                 "no heartbeat": "\x1b[31m"}
_RESET = "\x1b[0m"

# the stable row schema `--once --json` promises (absent values are
# null, never missing keys — scripts index these blindly)
ROW_KEYS = ("name", "dir", "source", "state", "pid", "phase", "step",
            "active", "slots", "occupancy", "queue", "tokens_per_s",
            "ttft_p99_ms", "blocks_in_use", "brownout", "draining",
            "alerts", "age_s", "restarts", "window_s",
            # introspection plane: the windowed dominant host segment
            # (obs/tickprof.py vocabulary) and host RSS in MB
            "dominant_segment", "rss_mb",
            # workload isolation: per-SLO-class queue depth and
            # what the self-operating layer is doing right now (engine:
            # class brownout / chunking; router: steering / scaling)
            "queue_interactive", "queue_batch", "act",
            # tiered KV cache (serve/hostcache.py): host-tier
            # hit rate and host-RAM occupancy — null on a tier-off
            # process, so the column distinguishes "disabled" from
            # "enabled but cold"
            "tier_hit_host", "host_cache_mb")


def discover(base: str | Path) -> list[tuple[str, Path]]:
    """(label, dir) per process under `base`: the base itself when it
    holds run artifacts (router stream or single-process run), plus
    each `replica_<i>/` child in numeric order."""
    base = Path(base)
    reps = sorted(
        (d for d in base.glob("replica_*") if d.is_dir()),
        key=lambda p: (not p.name.removeprefix("replica_").isdigit(),
                       int(p.name.removeprefix("replica_"))
                       if p.name.removeprefix("replica_").isdigit() else 0,
                       p.name))
    out: list[tuple[str, Path]] = []
    if any((base / n).exists() for n in (OBS_SOCKET_NAME,
                                         "heartbeat.json",
                                         "telemetry.jsonl")):
        out.append(("router" if reps else "process", base))
    out += [(f"replica {d.name.removeprefix('replica_')}", d)
            for d in reps]
    return out


def _row_from_exposition(row: dict, exp: dict) -> dict:
    row.update(source="socket", state="live", pid=exp.get("pid"),
               phase=exp.get("phase"),
               step=exp.get("tick", exp.get("step")),
               active=exp.get("active"), slots=exp.get("slots"),
               occupancy=exp.get("occupancy"), queue=exp.get("queue"),
               blocks_in_use=exp.get("blocks_in_use"),
               brownout=bool(exp.get("brownout")),
               draining=bool(exp.get("draining")),
               alerts=list(exp.get("alerts") or []),
               restarts=exp.get("restarts"), age_s=0.0)
    windows = exp.get("windows") or {}
    # the window the PROCESS reports, not a flag: the sockets own
    # their exposition window and the frame must attribute the
    # windowed columns to the span they actually cover
    row["window_s"] = windows.get("window_s")
    ttft = (windows.get("histograms") or {}).get("ttft_ms") or {}
    row["ttft_p99_ms"] = ttft.get("p99")
    tok = (windows.get("counters") or {}).get("tokens") or {}
    row["tokens_per_s"] = tok.get("per_s")
    gauges = (exp.get("metrics") or {}).get("gauges") or {}
    if row["tokens_per_s"] is None:
        # idle window: fall back to the lifetime gauge so the column
        # reads 0-ish truth instead of a hole
        row["tokens_per_s"] = gauges.get("tokens_per_s")
    if row["occupancy"] is None and gauges.get("slot_occupancy") \
            is not None:
        row["occupancy"] = gauges.get("slot_occupancy")
    if row["blocks_in_use"] is None:
        row["blocks_in_use"] = gauges.get("serve_blocks_in_use")
    row["tier_hit_host"] = gauges.get("serve_tier_hit_rate_host")
    row["host_cache_mb"] = gauges.get("serve_host_cache_mb")
    tp = exp.get("tickprof") or {}
    row["dominant_segment"] = tp.get("dominant")
    row["rss_mb"] = (exp.get("memory") or {}).get("rss_mb")
    qbc = exp.get("queue_by_class") or {}
    row["queue_interactive"] = qbc.get("interactive")
    row["queue_batch"] = qbc.get("batch")
    row["act"] = _act_cell(exp.get("act") or {})
    return row


def _act_cell(act: dict) -> str | None:
    """Compress the exposition's `act` payload into one cell — what the
    self-operating layer is DOING, not just measuring: an engine under
    a class brownout order or mid-chunked-prefill, a router steering
    traffic or running a scaled fleet. None when the process predates
    (or doesn't carry) the payload; '-' when it carries it and is
    idle — the difference between "can't act" and "nothing to do"."""
    if not act:
        return None
    bits: list[str] = []
    if act.get("class_brownout"):
        bits.append("cbrown")
    if act.get("chunking"):
        bits.append(f"chunk:{act['chunking']}")
    steered = act.get("steered") or []
    if steered:
        bits.append("steer:" + ",".join(str(i) for i in steered))
    if act.get("max_replicas"):
        bits.append(f"fleet:{act.get('fleet')}/{act['max_replicas']}")
    # router crash safety: replicas this life adopted from a
    # dead predecessor, and client streams resumed across the cut
    if act.get("adopted"):
        bits.append(f"adopt:{act['adopted']}")
    if act.get("resumes"):
        bits.append(f"res:{act['resumes']}")
    return "+".join(bits) or "-"


def _row_from_heartbeat(row: dict, hb: dict | None, *, now: float,
                        stale_s: float) -> dict:
    if hb is None:
        row.update(source=None, state="no heartbeat")
        return row
    age = heartbeat_age_s(hb, now)
    phase = hb.get("phase")
    if phase == "done":
        state = "done"
    elif age is not None and age > stale_s:
        state = "dead"
    else:
        state = "beating"
    row.update(source="heartbeat", state=state, pid=hb.get("pid"),
               phase=phase, step=hb.get("step"),
               active=hb.get("active"), queue=hb.get("queue"),
               alerts=list(hb.get("alerts") or []),
               rss_mb=hb.get("rss_mb"),
               age_s=round(age, 1) if age is not None else None)
    return row


def sample(name: str, d: Path, *, now: float | None = None,
           stale_s: float = DEFAULT_STALE_S,
           timeout_s: float = 0.5) -> dict:
    """One row for one process dir: exposition socket first (live
    truth), heartbeat fallback (the flight recorder's last word)."""
    now = time.time() if now is None else now
    row: dict = {k: None for k in ROW_KEYS}
    row.update(name=name, dir=str(d), brownout=False, draining=False,
               alerts=[])
    exp = read_exposition(d / OBS_SOCKET_NAME, timeout_s)
    if exp is not None and "error" not in exp:
        return _row_from_exposition(row, exp)
    return _row_from_heartbeat(row, read_heartbeat(d / "heartbeat.json"),
                               now=now, stale_s=stale_s)


def sample_all(base: str | Path, *, stale_s: float = DEFAULT_STALE_S,
               timeout_s: float = 0.5) -> list[dict]:
    now = time.time()
    return [sample(name, d, now=now, stale_s=stale_s,
                   timeout_s=timeout_s)
            for name, d in discover(base)]


def _fmt(v, nd: int = 1) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render(rows: list[dict], base: str, *, window_s: float,
           color: bool = True, now: float | None = None) -> str:
    """One frame: fixed-width table, ANSI-colored states."""
    now = time.time() if now is None else now
    cols = [("process", 11), ("state", 12), ("pid", 7), ("phase", 10),
            ("tick", 6), ("occ", 5), ("queue", 5), ("q i/b", 6),
            ("tok/s", 8),
            (f"ttft p99({window_s:.0f}s)", 14), ("blocks", 6),
            ("tier", 9), ("seg", 9), ("rss", 7),
            ("brown", 5), ("act", 12), ("alerts", 18), ("age", 5)]
    head = " ".join(f"{n:<{w}}" for n, w in cols)
    lines = [
        f"obs top — {base} · {time.strftime('%H:%M:%S', time.localtime(now))}"
        f" · window {window_s:.0f}s",
        head,
        "-" * len(head),
    ]
    for r in rows:
        occ = (_fmt(r["occupancy"], 2) if r["occupancy"] is not None
               else (f"{r['active']}" if r["active"] is not None else "—"))
        p99 = (f"{r['ttft_p99_ms']:.1f}ms"
               if isinstance(r["ttft_p99_ms"], (int, float)) else "—")
        rss = (f"{r['rss_mb']:.0f}M"
               if isinstance(r["rss_mb"], (int, float)) else "—")
        qib = ("—" if r["queue_interactive"] is None
               and r["queue_batch"] is None
               else f"{_fmt(r['queue_interactive'])}"
                    f"/{_fmt(r['queue_batch'])}")
        # host-tier cell: hit-rate/occupancy; "—" means the spill tier
        # is off on this process, 0.00/0M means on-but-cold
        tier = ("—" if r["host_cache_mb"] is None
                else f"{_fmt(r['tier_hit_host'], 2)}"
                     f"/{r['host_cache_mb']:.0f}M")
        cells = [r["name"], r["state"] or "?", _fmt(r["pid"]),
                 _fmt(r["phase"]), _fmt(r["step"]), occ,
                 _fmt(r["queue"]), qib,
                 _fmt(r["tokens_per_s"]), p99,
                 _fmt(r["blocks_in_use"]), tier,
                 _fmt(r["dominant_segment"]), rss,
                 _fmt(bool(r["brownout"])), _fmt(r["act"]),
                 ",".join(r["alerts"] or []) or "-", _fmt(r["age_s"], 0)]
        line = " ".join(f"{str(c):<{w}}" for c, (_, w) in zip(cells, cols))
        if color:
            c = _STATE_COLORS.get(r["state"] or "", "")
            if c:
                line = c + line + _RESET
        lines.append(line)
    firing = sorted({a for r in rows for a in (r["alerts"] or [])})
    dead = [r["name"] for r in rows
            if r["state"] in ("dead", "no heartbeat")]
    lines.append("")
    lines.append(
        f"{len(rows)} process(es); alerts firing: "
        f"{', '.join(firing) if firing else 'none'}"
        + (f"; DEAD: {', '.join(dead)}" if dead else ""))
    return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hyperion obs top",
        description="live fleet dashboard: poll each process's "
                    "exposition socket (heartbeat fallback for dead "
                    "ones) and render per-replica state, occupancy, "
                    "queue depth, windowed tokens/s and TTFT p99, "
                    "brownout, and firing SLO alerts")
    p.add_argument("target", help="run dir or router --base-dir "
                                  "(replica_*/ children discovered)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (no screen repaint)")
    p.add_argument("--json", action="store_true",
                   help="with --once: emit the machine-readable row "
                        "list instead of the table")
    p.add_argument("--interval", type=float, default=DEFAULT_INTERVAL_S,
                   help="refresh period in seconds (live mode)")
    p.add_argument("--stale-s", type=float, default=DEFAULT_STALE_S,
                   help="heartbeat age that renders a socketless "
                        "process as dead")
    p.add_argument("--timeout", type=float, default=0.5,
                   help="per-socket connect/read timeout in seconds")
    p.add_argument("--no-color", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    base = Path(args.target)
    if args.json and not args.once:
        print("--json needs --once (a repainting JSON stream helps "
              "nobody)", file=sys.stderr)
        return 2
    if not discover(base):
        print(f"nothing to watch under {base} — expected obs.sock, "
              "heartbeat.json, telemetry.jsonl, or replica_*/ dirs",
              file=sys.stderr)
        return 2
    color = not args.no_color and sys.stdout.isatty()

    def frame() -> list[dict]:
        return sample_all(base, stale_s=args.stale_s,
                          timeout_s=args.timeout)

    def window_of(rows: list[dict]) -> float:
        # the window the SOCKETS report — never a flag echo: the frame
        # must attribute windowed columns to the span they cover
        return next((r["window_s"] for r in rows
                     if r.get("window_s")), DEFAULT_WINDOW_S)

    if args.once:
        rows = frame()
        if args.json:
            print(json.dumps({"target": str(base),
                              "t_wall": time.time(),
                              "window_s": window_of(rows),
                              "rows": rows}, default=str))
        else:
            print(render(rows, str(base), window_s=window_of(rows),
                         color=color), end="")
        return 0
    try:
        while True:
            rows = frame()
            out = render(rows, str(base), window_s=window_of(rows),
                         color=color)
            sys.stdout.write(_ANSI_HOME_CLEAR + out)
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
