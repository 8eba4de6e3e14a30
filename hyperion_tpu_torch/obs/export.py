"""Live metric exposition — one JSON snapshot per connection, on a
small unix socket next to the process's heartbeat file.

The heartbeat (obs/heartbeat.py) is the passive half of liveness: a
file the process rewrites so a reader can tell hung from slow. This is
the active half: a LIVE process answers one request with its current
state — registry counters/gauges, windowed histogram summaries
(`MetricsRegistry.windowed_snapshot`), heartbeat phase, drain/brownout
flags, firing alerts — so `obs top` renders current truth for running
fleets and falls back to heartbeat files only for the dead ones.

Protocol, deliberately the dumbest thing that works: connect, send one
OPTIONAL JSON request line (or nothing at all), read one JSON line,
EOF. A client that sends an empty line — or goes quiet for 250 ms, so
a bare `nc -U <sock>` still works — gets the default snapshot; a JSON
dict with a `"cmd"` key is routed to the owner's `control_fn` (on-
demand profiling lives there), answered with the verb's own JSON
reply. No framing, no version negotiation beyond the `v` field. The
payload is built by a caller-supplied `payload_fn` on the EXPORTER
thread from host-side state only (python floats, bounded ring copies):
answering a snapshot request can never add a device sync or a jit
trace to the serving loop, which is the whole point of exposing
metrics the loop already keeps instead of measuring anything new.

Failure posture matches the heartbeat's: a socket that cannot bind, a
payload_fn that raises, a client that disconnects mid-write — all
degrade the observability plane, never the process it observes.
"""

from __future__ import annotations

import fcntl
import json
import os
import socket as socket_mod
import sys
import threading
import time
from pathlib import Path

OBS_SCHEMA = 1
OBS_SOCKET_NAME = "obs.sock"
DEFAULT_WINDOW_S = 60.0


def exposition_path(anchor: str | Path) -> Path:
    """The canonical socket location: `obs.sock` next to the anchor
    (a heartbeat/telemetry file) or inside it (a run directory) — the
    path `obs top` probes for each discovered process."""
    p = Path(anchor)
    if p.suffix in (".json", ".jsonl"):
        return p.parent / OBS_SOCKET_NAME
    return p / OBS_SOCKET_NAME


def prepare_socket_path(socket_path: str,
                        owner: str = "live process", bind=None):
    """Make `socket_path` bindable: a socket file that survived a
    crash (SIGKILL unlinks nothing) would fail the bind forever. Probe
    it first — a connection REFUSED means no listener owns it (stale:
    unlink); a successful connect means a live owner does (raise
    loudly instead of yanking a working socket out from under it).
    THE one implementation of this discipline: the serve transports
    (serve/server.py) delegate here, obs is jax-free, so both layers
    share it without serve's import chain. `owner` names the refuser
    in the error ("live server" for transports).

    The probe-unlink-bind window is racy on its own: two supervised
    children restarting at once can each probe the OTHER's socket in
    the instant between its bind and its first accept, read the
    refusal as stale, and unlink a fresh socket out from under its
    owner. So the whole window runs under an exclusive flock on a
    `.lock` sibling, and callers that bind pass the bind as a callback
    (`bind() -> bound server`) so it happens INSIDE the lock; the
    lock file itself is never unlinked (unlinking would let a third
    process lock a fresh inode while the second still holds the old
    one, resurrecting the race). Lock failures degrade to the old
    unlocked behavior — this is crash-hygiene, not correctness of the
    socket itself. Returns whatever `bind` returns (None without)."""
    lock_fd = None
    try:
        lock_fd = os.open(socket_path + ".lock",
                          os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
    except OSError:
        if lock_fd is not None:
            try:
                os.close(lock_fd)
            except OSError:
                pass
        lock_fd = None
    try:
        if os.path.exists(socket_path):
            probe = socket_mod.socket(socket_mod.AF_UNIX,
                                      socket_mod.SOCK_STREAM)
            probe.settimeout(0.25)
            try:
                probe.connect(socket_path)
            except OSError:
                try:
                    os.unlink(socket_path)
                except OSError:
                    pass
            else:
                raise RuntimeError(
                    f"socket {socket_path} is owned by a {owner} — "
                    "refusing to steal it (stop the other process or "
                    "pick another path)")
            finally:
                probe.close()
        return bind() if bind is not None else None
    finally:
        if lock_fd is not None:
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_UN)
            except OSError:
                pass
            try:
                os.close(lock_fd)
            except OSError:
                pass


class MetricsExporter:
    """Background one-shot-answer server for a process's live snapshot.

    `payload_fn() -> dict` supplies the body; the exporter adds the
    envelope (schema version, kind, pid, wall time). Start failures
    disable the exporter with a stderr note instead of killing the
    host process — observability must never take down what it
    observes."""

    def __init__(self, socket_path: str | Path, payload_fn, *,
                 label: str = "obs-export", control_fn=None):
        self.socket_path = str(socket_path)
        self._payload_fn = payload_fn
        # optional `control_fn(req: dict) -> dict` for "cmd" requests
        # (engine.control): absent -> every request gets the snapshot
        self._control_fn = control_fn
        self._label = label
        self._srv = None
        self._thread: threading.Thread | None = None
        self.enabled = False
        # True only once THIS exporter has bound the path: close()
        # must never unlink a socket some other live process owns (a
        # refused start() would otherwise take down the rightful
        # owner's exposition on its way out)
        self._bound = False

    def start(self) -> "MetricsExporter":
        import socketserver

        payload_fn = self._payload_fn
        control_fn = self._control_fn

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                req = None
                try:
                    # one optional request line: well-behaved clients
                    # (read_exposition) send at least b"\n" so the fast
                    # path never waits; a silent `nc -U` pays 250 ms
                    # and still gets the default snapshot
                    self.connection.settimeout(0.25)
                    line = self.rfile.readline(65536).strip()
                    if line:
                        req = json.loads(line.decode("utf-8"))
                except (OSError, json.JSONDecodeError,
                        UnicodeDecodeError, ValueError):
                    req = None
                finally:
                    try:
                        self.connection.settimeout(5.0)
                    except OSError:
                        pass
                if (isinstance(req, dict) and req.get("cmd")
                        and control_fn is not None):
                    kind = "control"
                    try:
                        doc = control_fn(req)
                        if not isinstance(doc, dict):
                            doc = {"error": "control_fn returned non-dict"}
                    except Exception as e:  # noqa: BLE001
                        doc = {"error": repr(e)[:500]}
                else:
                    kind = "exposition"
                    try:
                        doc = payload_fn()
                        if not isinstance(doc, dict):
                            doc = {"error": "payload_fn returned non-dict"}
                    except Exception as e:  # noqa: BLE001 — a snapshot bug
                        doc = {"error": repr(e)[:500]}  # answer, not kill
                rec = {"v": OBS_SCHEMA, "kind": kind,
                       "pid": os.getpid(), "t_wall": time.time(), **doc}
                try:
                    self.wfile.write(
                        json.dumps(rec, separators=(",", ":"),
                                   default=repr).encode("utf-8") + b"\n")
                except OSError:
                    pass  # client vanished between connect and read

        class Server(socketserver.ThreadingMixIn,
                     socketserver.UnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

            def handle_error(self, request, client_address):
                pass  # a broken client is its own problem

        try:
            Path(self.socket_path).parent.mkdir(parents=True,
                                                exist_ok=True)
            # bind inside the prepare lock: a sibling restarting at the
            # same instant must not probe-and-unlink this fresh socket
            self._srv = prepare_socket_path(
                self.socket_path,
                bind=lambda: Server(self.socket_path, Handler))
            self._bound = True
        except Exception as e:  # noqa: BLE001 — never kill the host loop
            print(f"[{self._label}] exposition disabled "
                  f"({self.socket_path}): {e}", file=sys.stderr)
            self._srv = None
            return self
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name=self._label, daemon=True)
        self._thread.start()
        self.enabled = True
        return self

    def close(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.enabled = False
        if self._bound:
            # only the binder unlinks: a refused start() must not take
            # down the rightful owner's socket on its way out
            self._bound = False
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    def __enter__(self) -> "MetricsExporter":
        return self if self.enabled or self._srv is not None \
            else self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def read_exposition(socket_path: str | Path,
                    timeout_s: float = 1.0) -> dict | None:
    """One snapshot request; None when nothing (or nothing parseable)
    answers — the caller's signal to fall back to the heartbeat file."""
    return _roundtrip(socket_path, b"\n", timeout_s)


def request_control(socket_path: str | Path, req: dict,
                    timeout_s: float = 5.0) -> dict | None:
    """Send one control verb (`{"cmd": ...}`) to a live exposition
    socket; the owner's `control_fn` answers. None when nothing
    answers or the owner predates the request-line protocol."""
    line = json.dumps(req, separators=(",", ":")).encode("utf-8") + b"\n"
    return _roundtrip(socket_path, line, timeout_s)


def _roundtrip(socket_path: str | Path, request: bytes,
               timeout_s: float) -> dict | None:
    buf = b""
    try:
        with socket_mod.socket(socket_mod.AF_UNIX,
                               socket_mod.SOCK_STREAM) as s:
            s.settimeout(timeout_s)
            s.connect(str(socket_path))
            # the (possibly empty) request line lets the exporter skip
            # its read timeout; pre-protocol servers just ignore it
            try:
                s.sendall(request)
            except OSError:
                pass
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
    except OSError:
        return None
    try:
        doc = json.loads(buf.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def profile_main(argv: list[str] | None = None) -> int:
    """`obs profile <dir> --seconds N [--out DIR]` — ask the live
    process whose obs.sock lives at/next to <dir> to capture an
    on-demand `torch.profiler` trace (Perfetto/chrome://tracing).
    Exit 0 when the trace started (or was already running), 1 when the
    backend cannot profile or nothing answered."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="obs profile",
        description="request an on-demand torch.profiler trace from a "
                    "live process via its exposition socket")
    ap.add_argument("dir", help="run dir / heartbeat path whose "
                                "obs.sock to talk to")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="trace duration (default 5)")
    ap.add_argument("--out", default=None,
                    help="trace output dir (default <dir>/profile)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw reply as JSON")
    args = ap.parse_args(argv)
    sock = exposition_path(args.dir)
    out = args.out or str(Path(args.dir) / "profile")
    reply = request_control(
        sock, {"cmd": "profile", "seconds": args.seconds, "out": out},
        timeout_s=max(5.0, args.seconds + 5.0))
    if reply is None:
        print(f"no live process answered at {sock}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(reply, indent=2, default=repr))
    else:
        status = reply.get("status", "error")
        print(f"profile: {status}"
              + (f" -> {reply.get('dir')}" if reply.get("dir") else "")
              + (f" ({reply.get('error')})" if reply.get("error") else ""))
    return 0 if reply.get("status") in ("started", "busy") else 1
