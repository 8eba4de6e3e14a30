"""Tiny JSONL client for the serve socket — tests, load drivers, and
the replica router's dispatch path.

Speaks exactly the `serve/server.py` wire protocol over a local unix
socket: one JSON object per line out (the request), a stream of JSON
objects per line back (token events, then a terminal `done` /
`rejected` / `timed_out` / `error`). No pooling, no discovery — but
`connect()` retries with backoff on the two errors a *supervised
restart* produces (connection refused while the new process warms up,
socket file briefly absent between unlink and rebind), because a
client that dies the instant its replica is restarted defeats the
whole crash-safety story. Retry classification rides
`utils/retry.py`; anything else (permission, a path that is not a
socket) still fails immediately.

Mid-STREAM disconnects get the same honesty the connect path has:
losing the wire after tokens flowed is never a silent truncation (a
caller must not mistake a half stream for eos). Without `resume` it
raises `StreamInterrupted` carrying the request id and the index of
the next token owed; with `resume=True` the client reconnects through
the same backoff and sends the wire protocol's resume verb —
`{"kind": "resume", "request_id": ..., "next_index": ...,
"request": {...}}` — deduping any overlap by stream index, so one
logical stream survives server (or router) lives.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
from typing import Iterator

from hyperion_tpu_torch.utils.retry import RetryPolicy, retry_call

TERMINAL_EVENTS = ("done", "rejected", "timed_out", "error")

#: default connect policy: rides out a supervised replica restart
#: (seconds of warmup) but gives up fast enough that "no server at all"
#: is still a prompt, classified failure
CONNECT_RETRY = RetryPolicy(tries=8, base_delay_s=0.05, max_delay_s=1.0,
                            deadline_s=10.0)

# a restarting server produces exactly these: REFUSED while nothing
# listens on the (still-present or re-bound) socket file, ENOENT in the
# window between the old file's unlink and the new bind, RESET when the
# old process died with the connection half-open
_TRANSIENT_CONNECT = (ConnectionRefusedError, ConnectionResetError,
                      FileNotFoundError)

_CLIENT_SEQ = itertools.count(1)


def _connect_transient(exc: BaseException) -> bool:
    return isinstance(exc, _TRANSIENT_CONNECT)


class StreamInterrupted(ConnectionError):
    """The wire died mid-stream before a terminal event. Carries what a
    caller needs to resume (or to report precisely): the request id and
    `next_index`, the index of the first token NOT delivered. A
    `ConnectionError` subclass so pre-resume failover handlers (the
    router's dispatch path, load drivers) keep classifying it as the
    retryable wire failure it is."""

    def __init__(self, message: str, *, request_id: str | None = None,
                 next_index: int = 0):
        super().__init__(message)
        self.request_id = request_id
        self.next_index = next_index


class ServeClient:
    """One connection, requests streamed one at a time.

    with ServeClient("/tmp/hyperion.sock") as c:
        for ev in c.stream(prompt_ids=[5, 9, 12], max_new_tokens=8):
            ...

    `retry` is the connect backoff policy (None disables: first
    refusal is final — the pre-restart-era behavior, still right for
    probes that must not wait). `resume=True` turns mid-stream
    disconnects into automatic reconnect-and-resume (up to
    `max_resumes` per request) instead of `StreamInterrupted`.
    """

    def __init__(self, socket_path: str, timeout_s: float = 60.0,
                 retry: RetryPolicy | None = CONNECT_RETRY,
                 resume: bool = False, max_resumes: int = 4):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self.retry = retry
        self.resume = resume
        self.max_resumes = max_resumes
        self._sock: socket.socket | None = None
        self._rfile = None

    def _connect_once(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout_s)
        try:
            s.connect(self.socket_path)
        except BaseException:
            s.close()
            raise
        return s

    def connect(self) -> "ServeClient":
        if self.retry is None:
            s = self._connect_once()
        else:
            s = retry_call(self._connect_once, policy=self.retry,
                           classify=_connect_transient)
        self._sock = s
        self._rfile = s.makefile("rb")
        return self

    def close(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass  # a reset connection may refuse even the close
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "ServeClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- api

    def stream(self, **request) -> Iterator[dict]:
        """Send one request, yield its event records through the
        terminal one. `request` carries the wire fields (prompt /
        prompt_ids, max_new_tokens, temperature, ...).

        The wire dying mid-stream raises `StreamInterrupted` (never a
        silent half stream); with `resume` enabled the client instead
        reconnects and resumes from its own last received index — the
        client's count is the authoritative high-water mark — deduping
        any overlap, so the caller sees one gapless stream."""
        if self._sock is None:
            raise RuntimeError("client not connected (use `with` or "
                               ".connect())")
        if self.resume and not request.get("id"):
            # resumption is keyed on the request id — mint one
            request = dict(request)
            request["id"] = f"c{os.getpid()}_{next(_CLIENT_SEQ)}"
        want = request.get("id")
        next_index = 0  # index of the next token this caller is owed
        resumes = 0
        self._sock.sendall(
            (json.dumps(request, separators=(",", ":")) + "\n")
            .encode("utf-8"))
        while True:
            rec = None
            err: BaseException | None = None
            try:
                raw = self._rfile.readline()
                if raw:
                    rec = json.loads(raw)
            except (OSError, json.JSONDecodeError,
                    UnicodeDecodeError) as e:
                err = e  # reset or torn line: the disconnect signature
            if not isinstance(rec, dict):
                # EOF / reset / torn tail mid-stream. Resume if asked
                # (the resume verb re-sends on every reconnect, so a
                # server that dies AGAIN during the resume just costs
                # another round); otherwise fail loudly with the index.
                while True:
                    if (not self.resume or want is None
                            or resumes >= self.max_resumes):
                        raise StreamInterrupted(
                            f"stream for {want!r} cut off at index "
                            f"{next_index} before a terminal event",
                            request_id=str(want) if want else None,
                            next_index=next_index) from err
                    resumes += 1
                    try:
                        self.close()
                        self.connect()
                        self._sock.sendall((json.dumps(
                            {"kind": "resume", "request_id": want,
                             "next_index": next_index,
                             "request": request},
                            separators=(",", ":")) + "\n")
                            .encode("utf-8"))
                        break
                    except OSError as e2:
                        err = e2
                continue
            if want is not None and rec.get("id") not in (want, None):
                continue  # another request's event on a shared channel
            if rec.get("event") == "token":
                i = rec.get("i")
                idx = i if isinstance(i, int) else next_index
                # dedup ONLY when resuming: a replayed index after a
                # reconnect is expected overlap. Without resume the
                # record is yielded as-is — a duplicate there is a
                # SERVER bug the caller (loadgen's duplicate_tokens
                # gate) must be able to see, not have masked here.
                if self.resume and idx < next_index:
                    continue
                next_index = max(next_index, idx + 1)
            yield rec
            if rec.get("event") in TERMINAL_EVENTS:
                return

    def generate(self, **request) -> dict:
        """Blocking convenience: collect the stream, return
        {"tokens": [...], "final": <terminal record>}."""
        tokens: list[int] = []
        final: dict = {}
        for rec in self.stream(**request):
            if rec.get("event") == "token" and rec.get("token") is not None:
                tokens.append(int(rec["token"]))
            if rec.get("event") in TERMINAL_EVENTS:
                final = rec
        return {"tokens": tokens, "final": final}
