"""JSONL serving front end — `hyperion_tpu/serve/server.py` in PyTorch.

    python -m hyperion_tpu_torch.cli.main serve --ckpt model.npz \\
        [--tokenizer-dir DIR | --no-tokenizer] [--socket PATH]

Two transports over one wire protocol, one JSON object per line:
stdin/stdout (the default; drains on EOF) and a local unix socket
(`--socket PATH`: a threaded acceptor, each connection receives exactly
its own requests' events; `serve/client.py` is the matching client).
A request line:
    {"id": "r1", "prompt": "text", "max_new_tokens": 32,
     "temperature": 0.0, "top_k": 0, "top_p": 1.0, "seed": 0,
     "deadline_s": 5.0, "class": "interactive", "tenant": "team-a"}
`prompt_ids` (a raw int list) stands in for `prompt`; text prompts need
the byte-level BPE tokenizer (`--tokenizer-dir`, `data/bpe.py`).
Every response line carries the request id:
    {"id": "r1", "event": "token", "token": 17, "i": 0, "text": "..."}
    {"id": "r1", "event": "done", "n_tokens": 32, "ttft_ms": 12.3}
    {"id": "r1", "event": "rejected"|"timed_out", "reason": "..."}
    {"id": null, "event": "error", "error": "..."}   (unparseable line)

A client cut off mid-stream reconnects and sends the resume verb
    {"kind": "resume", "request_id": "r1", "next_index": 7,
     "request": {...the original request line...}}
and receives the rest of the stream (tokens with index >= 7, then the
terminal line) under the original id: the request is recomputed under a
suffixed wire id (sampling is seeded by seed and position, so the
stream is the same) and the sink drops the indices the client holds.

The engine loop runs on the main thread; transports only submit host
requests (numpy prompts) into the thread-safe admission queue, and the
sinks run on the engine thread, so no other thread touches the card.
The socket listens only after `warmup` has captured every graph. SIGTERM or
SIGINT drains gracefully (and spills the flight record), a second one
stops at once. The engine's deferred decode paths are flags:
`--spec-k`/`--draft`, `--prefill-chunk`, `--host-cache-mb` (persisted
next to the journal, else next to the telemetry stream), `--brownout*`
and `--slo-*`.

Crash safety and live observation, as in the reference: `--journal`
write-ahead-logs every admission and token, and a restart replays
unfinished requests bit-identically before serving; `--supervise` runs
the server as a child under the restart loop of `supervisor.py`
(journal replay, poison-pill quarantine, `--hang-timeout` heartbeat
watchdog), logging to stderr because stdout is the wire; `--chaos`
injects the serve faults of `testing/chaos.py`. With telemetry on
(`HYPERION_TELEMETRY`), the heartbeat, `flight.json` and the exposition
socket `obs.sock` (snapshots, `profile` and `class_brownout` verbs) sit
next to the stream.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import threading
import time


def event_record(ev, tok=None) -> dict | list:
    """TokenEvent -> one wire record (a token line and the terminal line
    when the token finishes the request)."""
    req = ev.request
    if ev.kind == "done":
        # journal recovery found the output already complete: the
        # client is owed only the terminal line the crash swallowed
        return {"id": req.id, "event": "done",
                "n_tokens": len(req.tokens), "recovered": True}
    if ev.kind != "token":
        return {"id": req.id, "event": ev.kind, "reason": ev.reason}
    # `i` is the token's index in the request's stream (the engine
    # appends before the sink runs, so the newest token is the last)
    rec: dict = {"id": req.id, "event": "token", "token": ev.token,
                 "i": len(req.tokens) - 1}
    if tok is not None and ev.token is not None:
        try:
            rec["text"] = tok.decode([ev.token])
        except Exception:  # noqa: BLE001 — a weird id must not kill the stream
            pass
    if ev.finished:
        done: dict = {"id": req.id, "event": "done",
                      "n_tokens": len(req.tokens)}
        if req.first_token_at is not None and req.submitted_at:
            done["ttft_ms"] = round(
                (req.first_token_at - req.submitted_at) * 1000.0, 3)
        if tok is not None:
            eos = getattr(tok, "eos_id", None)
            done["text"] = tok.decode([t for t in req.tokens if t != eos])
        rec = [rec, done]
    return rec


def parse_request_line(line: str, tok=None, defaults: dict | None = None):
    """One wire line -> Request, or an error record. Unknown keys are
    ignored (forward compatibility beats strictness on a line
    protocol)."""
    from hyperion_tpu_torch.serve.queue import Request

    defaults = defaults or {}
    try:
        doc = json.loads(line)
    except json.JSONDecodeError as e:
        return {"id": None, "event": "error", "error": f"bad json: {e}"}
    if not isinstance(doc, dict):
        return {"id": None, "event": "error",
                "error": "request line must be a JSON object"}
    if "prompt_ids" in doc:
        ids = doc["prompt_ids"]
    elif "prompt" in doc:
        if tok is None:
            return {"id": doc.get("id"), "event": "error",
                    "error": "text prompt needs a tokenizer "
                             "(--tokenizer-dir); send prompt_ids"}
        ids = tok.encode(str(doc["prompt"]))
    else:
        return {"id": doc.get("id"), "event": "error",
                "error": "request needs 'prompt' or 'prompt_ids'"}
    try:
        return Request(
            prompt_ids=ids,
            id=str(doc.get("id", "")),
            max_new_tokens=int(doc.get("max_new_tokens",
                                       defaults.get("max_new_tokens", 32))),
            temperature=float(doc.get("temperature", 0.0)),
            top_k=int(doc.get("top_k", 0)),
            top_p=float(doc.get("top_p", 1.0)),
            seed=int(doc.get("seed", 0)),
            deadline_s=(float(doc["deadline_s"])
                        if doc.get("deadline_s") is not None else None),
            sla_class=str(doc.get("class", "interactive")),
            tenant=(str(doc["tenant"])
                    if doc.get("tenant") is not None else None),
            trace=(doc["trace"] if isinstance(doc.get("trace"), dict)
                   else None),
        )
    except (TypeError, ValueError) as e:
        return {"id": doc.get("id"), "event": "error",
                "error": f"bad request field: {e}"}


# ------------------------------------------------------ stream resume
#
# The recompute runs under a suffixed wire id, so the engine and the
# journal never see one id twice; the sink rewrites it back before the
# client sees a byte, and drops the indices below `next_index`.

_RESUME_SEQ = itertools.count(1)


def maybe_resume_doc(line: str) -> dict | None:
    """Parse `line` as a resume verb, or None (a plain request)."""
    if '"resume"' not in line:
        return None
    try:
        doc = json.loads(line)
    except json.JSONDecodeError:
        return None
    if isinstance(doc, dict) and doc.get("kind") == "resume":
        return doc
    return None


def resume_sink(writer, tok, rid: str, next_index: int):
    """Sink for a resume recompute: drop already-delivered indices,
    rewrite the suffixed wire id back to the client's."""
    def sink(ev):
        recs = event_record(ev, tok)
        recs = recs if isinstance(recs, list) else [recs]
        out = []
        for r in recs:
            if r.get("event") == "token":
                i = r.get("i")
                if isinstance(i, int) and i < next_index:
                    continue  # the client already holds it
            r = dict(r)
            r["id"] = rid
            out.append(r)
        if out:
            writer.write(out)
    return sink


def submit_resume(engine, doc: dict, writer, tok=None,
                  defaults: dict | None = None):
    """Answer one resume verb: resubmit the carried request under a
    fresh wire id with a dedup-filtering sink. Returns the submitted
    Request, or None when the verb was rejected on the spot."""
    rid = str(doc.get("request_id") or "")
    try:
        next_index = max(0, int(doc.get("next_index", 0)))
    except (TypeError, ValueError):
        next_index = 0
    carried = doc.get("request")
    if not rid or not isinstance(carried, dict):
        writer.write({"id": rid or None, "event": "rejected",
                      "reason": "unknown_request"})
        return None
    carried = dict(carried)
    carried["id"] = f"{rid}~r{next(_RESUME_SEQ)}"
    parsed = parse_request_line(
        json.dumps(carried, separators=(",", ":")), tok, defaults)
    if isinstance(parsed, dict):  # error record
        parsed["id"] = rid
        engine.reject_unparsed(rid, parsed.get("error") or "")
        writer.write(parsed)
        return None
    parsed.sink = resume_sink(writer, tok, rid, next_index)
    engine.tracer.event("stream_resume", request=rid,
                        wire_id=parsed.id, next_index=next_index)
    engine.submit(parsed)
    return parsed


class _LineWriter:
    """Locked JSONL writer — transports interleave whole lines, never
    partial ones. Accepts text or binary files."""

    def __init__(self, f):
        self._f = f
        self._lock = threading.Lock()

    def write(self, rec) -> None:
        recs = rec if isinstance(rec, list) else [rec]
        with self._lock:
            for r in recs:
                line = json.dumps(r, separators=(",", ":")) + "\n"
                try:
                    self._f.write(line)
                except TypeError:
                    self._f.write(line.encode("utf-8"))
            self._f.flush()


def serve_jsonl(engine, infile, outfile, tok=None,
                defaults: dict | None = None,
                drain=None, drain_timeout_s: float = 30.0,
                hard_stop=None) -> dict:
    """stdin/stdout (or any file-pair) mode: a reader thread feeds the
    queue; the engine loop drains on EOF. `drain` (a threading.Event)
    flips the engine to draining; `hard_stop` aborts immediately.
    Returns the engine summary."""
    out = _LineWriter(outfile)
    eof = threading.Event()

    def sink(ev):
        out.write(event_record(ev, tok))

    # journal recovery first: requests a previous life owed resume at
    # the head of the queue, streaming to the same stdout the crashed
    # process used (the supervisor shares the pipe across restarts, so
    # the client sees one continuous stream)
    engine.replay_pending(sink)

    def reader():
        try:
            for line in infile:
                try:
                    line = line.strip()
                    if not line:
                        continue
                    if (rdoc := maybe_resume_doc(line)) is not None:
                        submit_resume(engine, rdoc, out, tok, defaults)
                        continue
                    parsed = parse_request_line(line, tok, defaults)
                    if isinstance(parsed, dict):  # error record
                        engine.reject_unparsed(parsed.get("id"),
                                               parsed.get("error") or "")
                        out.write(parsed)
                        continue
                    parsed.sink = sink
                    engine.submit(parsed)
                except Exception as e:  # noqa: BLE001
                    # nothing a client sends may kill the reader — and
                    # never the engine thread, which this loop never runs
                    engine.reject_unparsed(None, repr(e))
        finally:
            eof.set()

    def should_stop():
        if drain is not None and drain.is_set():
            engine.begin_drain(drain_timeout_s)  # idempotent
        return hard_stop is not None and hard_stop.is_set()

    t = threading.Thread(target=reader, name="serve-stdin", daemon=True)
    t.start()
    summary = engine.run(should_stop=should_stop, drain_when=eof.is_set)
    t.join(timeout=5)
    return summary


def prepare_socket_path(socket_path: str, bind=None):
    """Make `socket_path` bindable: a stale socket file left by a crash
    is unlinked, a live server's is refused (obs/export.py's probe, under
    its flock). Pass the bind as `bind() -> server` so it happens inside
    the lock; returns the bound server."""
    from hyperion_tpu_torch.obs.export import (
        prepare_socket_path as _prepare,
    )

    return _prepare(socket_path, owner="live server", bind=bind)


def serve_socket(engine, socket_path: str, tok=None,
                 defaults: dict | None = None,
                 should_stop=None, ready=None,
                 drain=None, drain_timeout_s: float = 30.0,
                 hard_stop=None) -> dict:
    """Unix-socket mode: a threaded acceptor submits, the engine loop
    (this thread) decodes, and each connection gets exactly its own
    requests' events. `ready` (an optional threading.Event) is set once
    the socket listens. `drain` flips graceful shutdown as on stdin;
    journal-replayed requests have no surviving connection, so their
    continuations run sink-less (a reconnecting client resumes)."""
    import os
    import socketserver

    engine.replay_pending(None)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            writer = _LineWriter(self.wfile)
            pending: list = []
            for raw in self.rfile:
                try:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    if (rdoc := maybe_resume_doc(line)) is not None:
                        resumed = submit_resume(engine, rdoc, writer,
                                                tok, defaults)
                        if resumed is not None:
                            pending.append(resumed)
                        continue
                    parsed = parse_request_line(line, tok, defaults)
                    if isinstance(parsed, dict):
                        engine.reject_unparsed(parsed.get("id"),
                                               parsed.get("error") or "")
                        writer.write(parsed)
                        continue
                    parsed.sink = lambda ev: writer.write(
                        event_record(ev, tok))
                    pending.append(parsed)
                    engine.submit(parsed)
                except Exception as e:  # noqa: BLE001 — a hostile or
                    # half-dead connection is its own problem, never
                    # the engine's
                    engine.reject_unparsed(None, repr(e))
                    break
            for req in pending:  # connection half-closed: finish streams
                req.done.wait(timeout=600)

    class Server(socketserver.ThreadingMixIn,
                 socketserver.UnixStreamServer):
        daemon_threads = True
        allow_reuse_address = True

        def handle_error(self, request, client_address):
            # a client that died mid-stream: evidence, never a server death
            engine.tracer.event("client_error",
                                client=str(client_address))

    srv = prepare_socket_path(
        socket_path, bind=lambda: Server(socket_path, Handler))
    acceptor = threading.Thread(target=srv.serve_forever,
                                name="serve-accept", daemon=True)
    acceptor.start()
    if ready is not None:
        ready.set()

    def _stop():
        if drain is not None and drain.is_set():
            engine.begin_drain(drain_timeout_s)  # idempotent
        if hard_stop is not None and hard_stop.is_set():
            return True  # second signal: stop now, journal holds the rest
        return bool(should_stop and should_stop())

    try:
        summary = engine.run(
            should_stop=_stop,
            # a socket server idles between connections; only an
            # explicit stop (or the drain signal) drains it
            drain_when=lambda: bool(should_stop and should_stop()),
        )
    finally:
        srv.shutdown()
        srv.server_close()
        try:
            os.unlink(socket_path)
        except OSError:
            pass
    return summary


DEFAULT_JOURNAL = "data/serve_journal.jsonl"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hyperion_tpu_torch.serve.server",
        description="continuous-batching inference server over a gathered "
                    "Llama export, JSONL on stdin/stdout, PyTorch/CUDA",
    )
    p.add_argument("--ckpt", required=True,
                   help="gathered-export .npz (written by the trainers)")
    p.add_argument("--tokenizer-dir", default="data/tokenizer",
                   help="byte-level BPE tokenizer (vocab.json + "
                        "merges.txt, data/bpe.py) for text prompts")
    p.add_argument("--no-tokenizer", action="store_true",
                   help="serve raw prompt_ids only (no text encode/"
                        "decode; eos disabled unless --eos-id)")
    p.add_argument("--max-len", type=int, default=256,
                   help="per-slot KV-cache length: prompt + max_new_tokens "
                        "must fit (also the admission bound)")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent requests decoded per tick")
    p.add_argument("--block-size", type=int, default=16,
                   help="tokens per KV-cache block")
    p.add_argument("--paged-attn", choices=("gather", "pallas"),
                   default="pallas",
                   help="paged-cache read strategy: 'gather' copies "
                        "each slot's whole block chain into a "
                        "contiguous view every tick (the plain read, on "
                        "the card too); 'pallas' (the default here; the "
                        "reference's is 'gather') runs the paged "
                        "attention kernel, which walks the block table "
                        "and reads the KV pools in place. A CPU run "
                        "always takes the gather read. Streams stay "
                        "deterministic; the memory ledger shows the "
                        "saved copy as kv_gather_bytes_per_tick=0")
    p.add_argument("--num-blocks", type=int, default=0,
                   help="KV pool size in blocks incl. the null block "
                        "(0 = auto: slots x ceil(max_len/block_size) + 1)")
    p.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="radix prefix reuse (--no-prefix-cache to disable)")
    p.add_argument("--admission", choices=("reserve", "optimistic"),
                   default="reserve",
                   help="block-aware admission: 'reserve' covers each "
                        "request's worst case up front; 'optimistic' admits "
                        "on prompt fit and preempts when the pool runs dry")
    p.add_argument("--host-cache-mb", type=int, default=0,
                   help="tiered KV: host-RAM spill tier for the radix "
                        "cache in MB (0 = off). Evicted prefix chains "
                        "demote to host buffers under this LRU budget and "
                        "a re-hit restores them with one host->device "
                        "copy instead of a re-prefill; with telemetry on, "
                        "the store is saved next to the stream on drain "
                        "and loaded at start. Needs --prefix-cache")
    p.add_argument("--queue-capacity", type=int, default=64,
                   help="admission queue bound; beyond it requests are "
                        "rejected with reason queue_full")
    p.add_argument("--prefill-budget", type=int, default=512,
                   help="prompt tokens admitted per scheduling round")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill: prompts longer than this fill "
                        "the cache in chunks of this size, one per step, "
                        "interleaved with decode ticks (0 = off); "
                        "temperature-0 output is unchanged")
    p.add_argument("--max-new-default", type=int, default=32,
                   help="max_new_tokens when a request omits it")
    # ---- SLO classes (serve/queue.py) ----
    p.add_argument("--interactive-weight", type=int, default=3,
                   help="weighted-fair admission: interactive picks per "
                        "round-robin cycle (vs --batch-weight)")
    p.add_argument("--batch-weight", type=int, default=1,
                   help="weighted-fair admission: batch picks per cycle")
    p.add_argument("--batch-capacity", type=int, default=0,
                   help="separate queue bound for class=batch requests "
                        "(0 = share --queue-capacity)")
    p.add_argument("--batch-deadline-s", type=float, default=0.0,
                   help="default deadline for class=batch requests that "
                        "omit deadline_s (0 = none)")
    # ---- speculative decoding (serve/draft.py) ----
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: draft tokens verified per "
                        "slot per tick (0 = off); each tick then emits "
                        "1..k+1 tokens per slot for ONE target forward, "
                        "and temperature-0 output is unchanged. Needs "
                        "--draft")
    p.add_argument("--draft", choices=("ngram", "off"), default="off",
                   help="draft source for --spec-k: 'ngram' = suffix "
                        "lookup over each slot's prompt + generated "
                        "tokens; 'off' disables speculation")
    p.add_argument("--eos-id", type=int, default=None,
                   help="override the eos token id (default: the "
                        "tokenizer's)")
    p.add_argument("--device", default="cuda",
                   help="torch device for weights and KV pools (the plain "
                        "PyTorch path runs with --device cpu)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="compute dtype")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="listen on a local unix socket instead of "
                        "stdin/stdout")
    p.add_argument("--warmup-lens", default="8,32",
                   help="comma-separated prompt lengths to build prefill "
                        "graphs for (the tick always warms)")
    p.add_argument("--heartbeat-every", type=int, default=25,
                   help="serve-phase heartbeat cadence in ticks")
    p.add_argument("--chaos", default="",
                   help="deterministic fault plan (testing/chaos.py): "
                        "stall@tick=N:SECS, slow_client@tick=N:SECS, "
                        "kill@tick=N, crash@tick=N, journal_io_fail@p=X, "
                        "poison_request@id=ID, ... (tick faults fire once "
                        "per supervisor lineage)")
    # ---- crash safety: journal + supervised restarts + drain ----
    p.add_argument("--journal", default="", metavar="PATH",
                   help="append-only request journal (JSONL WAL): every "
                        "admission and emitted token is recorded so a "
                        "crashed server's restart replays unfinished "
                        "requests to bit-identical completion "
                        "(serve/journal.py); --supervise defaults this to "
                        f"{DEFAULT_JOURNAL}")
    p.add_argument("--supervise", action="store_true",
                   help="run the server as a supervised child: on a crash, "
                        "restart with backoff and replay the journal; a "
                        "request that crashes the server repeatedly is "
                        "quarantined (request_poisoned)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="--supervise: restarts before giving up with exit 3")
    p.add_argument("--hang-timeout", type=float, default=120.0,
                   help="--supervise: SIGKILL a child whose heartbeat goes "
                        "stale this many seconds (0 = off; needs telemetry "
                        "for the heartbeat file)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="SIGTERM/SIGINT: seconds granted to in-flight and "
                        "queued requests before a hard stop; a fully "
                        "drained journal is marked clean")
    # ---- overload brownout ----
    p.add_argument("--brownout", action="store_true",
                   help="degrade gracefully under overload: past the "
                        "queue-depth or queue-wait p95 watermark, shed "
                        "queued requests whose deadline is already "
                        "unmeetable (reason shed_deadline) and optionally "
                        "clamp max_new_tokens; exits at half the watermark")
    p.add_argument("--brownout-depth", type=int, default=0,
                   help="queue-depth enter watermark (0 = 3/4 of "
                        "--queue-capacity)")
    p.add_argument("--brownout-wait-s", type=float, default=0.0,
                   help="queue-wait p95 enter watermark in seconds "
                        "(0 = depth watermark only)")
    p.add_argument("--brownout-clamp", type=int, default=0,
                   help="while browned out, clamp each new admission's "
                        "max_new_tokens to this (0 = shed only)")
    # ---- SLO burn-rate alerting (obs/slo.py) ----
    p.add_argument("--slo-ttft-p99-ms", type=float, default=0.0,
                   help="SLO target: windowed TTFT p99 under this many ms "
                        "(0 = off); breaching it in BOTH burn windows "
                        "raises an alert_raised event and an `alerts` "
                        "heartbeat field, clearing needs both under 90%%")
    p.add_argument("--slo-reject-rate", type=float, default=0.0,
                   help="SLO target: windowed rejected/(accepted+rejected) "
                        "budget (e.g. 0.05; 0 = off)")
    p.add_argument("--slo-availability", type=float, default=0.0,
                   help="SLO target: windowed completed/(completed+"
                        "rejected+timed_out) floor (e.g. 0.99; 0 = off)")
    p.add_argument("--slo-fast-s", type=float, default=0.0,
                   help="fast burn window in seconds (0 = 60)")
    p.add_argument("--slo-slow-s", type=float, default=0.0,
                   help="slow burn window in seconds (0 = 600)")
    return p


def _strip_supervise_flags(argv: list[str]) -> list[str]:
    from hyperion_tpu_torch.supervisor import strip_flags

    return strip_flags(argv, {"--supervise"},
                       {"--max-restarts", "--hang-timeout"})


def _env_telemetry_path() -> str | None:
    """The stream path the child's `from_env` resolves, computed without
    importing the serving stack (the supervisor parent needs only the
    heartbeat file's place)."""
    import os

    val = os.environ.get("HYPERION_TELEMETRY", "")
    if val in ("", "0"):
        return None
    return "data/telemetry.jsonl" if val == "1" else val


def supervise_serve(argv: list[str], args) -> int:
    """`--supervise`: the crash loop around the serving child — the
    restart core of `supervisor.py` with the serve policy: any crash
    restarts with backoff (the child replays its request journal on the
    way up), and a heartbeat gone stale past --hang-timeout gets the
    child SIGKILLed (a wedged engine never exits by itself). Between
    lives it logs the port's `obs doctor` verdict on the child's stream.
    The parent never touches the card."""
    from pathlib import Path

    from hyperion_tpu_torch.supervisor import (
        Decision,
        heartbeat_watchdog,
        run_child,
        supervise_loop,
    )

    def log(msg: str) -> None:
        # stderr, always: the children's stdout is the client's wire
        print(msg, file=sys.stderr, flush=True)

    tele = _env_telemetry_path()
    hb_path = str(Path(tele).parent / "heartbeat.json") if tele else None
    runner = run_child
    if args.hang_timeout > 0 and hb_path:
        runner = heartbeat_watchdog(hb_path, args.hang_timeout, log=log)

    def decide(rc: int) -> Decision:
        verdict = None
        if tele is not None:
            try:
                from hyperion_tpu_torch.obs.doctor import diagnose

                # the stream file itself, not its directory: the env
                # var may name anything, not just telemetry.jsonl
                verdict = diagnose(tele).get("verdict")
            except Exception as e:  # noqa: BLE001 — triage is advisory
                log(f"[serve-supervisor] doctor consult failed: {e}")
        log(f"[serve-supervisor] child exit {rc}; doctor verdict: "
            f"{verdict or 'unavailable'}; restarting with journal "
            "replay")
        return Decision.restart()

    child_argv = _strip_supervise_flags(argv)
    if "--journal" not in " ".join(child_argv):
        # replay is the point of a supervised restart: default the WAL
        # on and pin its path so every child shares it
        child_argv += ["--journal", args.journal or DEFAULT_JOURNAL]
    child = [sys.executable, "-m", "hyperion_tpu_torch.serve.server",
             *child_argv]
    return supervise_loop(child, decide=decide,
                          max_restarts=args.max_restarts,
                          run_child=runner, label="serve-supervisor",
                          log=log)


def main(argv=None, *, device=None) -> int:
    """CLI entry. `device` overrides `--device` for embedded callers."""
    import os
    import signal
    from pathlib import Path

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.supervise:
        return supervise_serve(argv, args)

    from hyperion_tpu_torch import resolve_device
    from hyperion_tpu_torch.checkpoint.io import load_gathered
    from hyperion_tpu_torch.infer.generate import model_from_npz
    from hyperion_tpu_torch.obs import heartbeat as obs_heartbeat
    from hyperion_tpu_torch.obs import trace as obs_trace
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.journal import RequestJournal

    dev = resolve_device(device if device is not None else args.device)
    tok = None
    if not args.no_tokenizer:
        from hyperion_tpu_torch.data.bpe import ByteBPE

        tok = ByteBPE.load(args.tokenizer_dir)
    attempt = int(os.environ.get("HYPERION_ATTEMPT", "0") or 0)
    # under a router each replica stamps its index onto every record
    # (the tracer's proc field) and heartbeat: the fleet doctor and the
    # timeline's replica tags read it back
    replica = os.environ.get("HYPERION_REPLICA", "")
    replica_idx = int(replica) if replica.isdigit() else None
    run_tag = ("serve_torch" if replica_idx is None
               else f"serve_r{replica_idx}")
    tracer = obs_trace.from_env("data/telemetry.jsonl",
                                run=f"{run_tag}_{int(time.time())}",
                                proc=replica_idx)
    static = {"attempt": attempt}
    if replica_idx is not None:
        static["replica"] = replica_idx
    hb = obs_heartbeat.Heartbeat.for_tracer(
        tracer, every=args.heartbeat_every, static=static)
    hb.pulse(phase="load")
    chaos = None
    if args.chaos:
        from hyperion_tpu_torch.testing import chaos as chaos_mod

        # state file next to the journal (or the stream): tick faults
        # fire once per supervisor LINEAGE, so a restarted child does
        # not re-die at the already-fired tick
        state_dir = None
        if args.journal:
            state_dir = Path(args.journal).parent
        elif _env_telemetry_path():
            state_dir = Path(_env_telemetry_path()).parent
        chaos = chaos_mod.activate(
            args.chaos,
            state_path=(state_dir / "serve_chaos_state.json"
                        if state_dir is not None else None))
    journal = None
    if args.journal:
        journal = RequestJournal(
            args.journal,
            fault=chaos.journal_io if chaos is not None else None)
    with tracer.span("load") as ld:
        model, cached = model_from_npz(load_gathered(args.ckpt),
                                       args.max_len, dtype=args.dtype,
                                       device=dev)
        if not cached:
            raise SystemExit(f"{args.ckpt}: the server decodes Llama "
                             "exports (a paged KV pool); decode this one "
                             "with python -m hyperion_tpu_torch.infer")
        if args.paged_attn != model.cfg.paged_attn_impl:
            from hyperion_tpu_torch.models.llama import set_paged_attn

            set_paged_attn(model, args.paged_attn)
        ld.set(ckpt=args.ckpt, device=str(dev), dtype=args.dtype)
    # the host tier persists next to the journal when there is one,
    # next to the telemetry stream otherwise, or nowhere
    host_cache_dir = ""
    if args.host_cache_mb > 0:
        if args.journal:
            host_cache_dir = str(Path(args.journal).parent / "hostcache")
        elif _env_telemetry_path():
            host_cache_dir = str(
                Path(_env_telemetry_path()).parent / "hostcache")
    eos_id = args.eos_id
    if eos_id is None and tok is not None:
        eos_id = tok.eos_id
    engine = Engine(
        model,
        EngineConfig(
            slots=args.slots, max_len=args.max_len, eos_id=eos_id,
            queue_capacity=args.queue_capacity,
            prefill_budget=args.prefill_budget,
            prefill_chunk=args.prefill_chunk,
            interactive_weight=args.interactive_weight,
            batch_weight=args.batch_weight,
            batch_capacity=args.batch_capacity,
            batch_deadline_s=args.batch_deadline_s,
            block_size=args.block_size, num_blocks=args.num_blocks,
            prefix_cache=args.prefix_cache, admission=args.admission,
            host_cache_mb=args.host_cache_mb,
            host_cache_dir=host_cache_dir,
            spec_k=args.spec_k, draft=args.draft,
            brownout=args.brownout,
            brownout_depth=args.brownout_depth,
            brownout_wait_s=args.brownout_wait_s,
            brownout_clamp=args.brownout_clamp,
            slo_ttft_p99_ms=args.slo_ttft_p99_ms,
            slo_reject_rate=args.slo_reject_rate,
            slo_availability=args.slo_availability,
            slo_fast_s=args.slo_fast_s,
            slo_slow_s=args.slo_slow_s,
        ),
        tracer=tracer, heartbeat=hb, chaos=chaos, journal=journal,
        flight_path=(hb.path.parent / "flight.json" if hb.enabled
                     else None),
        device=dev,
    )
    hb.pulse(phase="warmup")
    warm = [int(x) for x in args.warmup_lens.split(",") if x.strip()]
    engine.warmup(warm or None)

    # live exposition socket (obs/export.py): obs.sock next to the
    # heartbeat file, answering one JSON snapshot per connection and the
    # control verbs. Rides the heartbeat's enablement.
    exporter = None
    if hb.enabled:
        from hyperion_tpu_torch.obs.export import (
            MetricsExporter,
            exposition_path,
        )

        exporter = MetricsExporter(exposition_path(hb.path),
                                   engine.exposition, label="serve-obs",
                                   control_fn=engine.control).start()

    drain_evt = threading.Event()
    hard_evt = threading.Event()

    def _on_signal(signum, frame):
        if drain_evt.is_set():
            hard_evt.set()
        else:
            print(f"[serve] signal {signum}: draining (timeout "
                  f"{args.drain_timeout:.0f}s; signal again to stop now)",
                  file=sys.stderr)
            # spill the flight record NOW: if the drain never finishes
            # the post-mortem still has the final ticks
            try:
                engine.flight_spill("sigterm", signum=int(signum))
            except Exception:  # noqa: BLE001 — never die in a handler
                pass
        drain_evt.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread (embedded use): no signal drain

    defaults = {"max_new_tokens": args.max_new_default}
    try:
        if args.socket:
            print(f"[serve] listening on {args.socket} "
                  f"({args.slots} slots, max_len {args.max_len})",
                  file=sys.stderr)
            serve_socket(engine, args.socket, tok, defaults,
                         drain=drain_evt,
                         drain_timeout_s=args.drain_timeout,
                         hard_stop=hard_evt)
        else:
            serve_jsonl(engine, sys.stdin, sys.stdout, tok, defaults,
                        drain=drain_evt,
                        drain_timeout_s=args.drain_timeout,
                        hard_stop=hard_evt)
    except KeyboardInterrupt:
        pass
    finally:
        if exporter is not None:
            exporter.close()
        if journal is not None:
            if engine.idle:
                # fully drained: mark the WAL clean so the next start
                # replays nothing
                journal.close_clean()
            else:
                journal.close()
                print(f"[serve] {len(engine.queue) + engine.n_active} "
                      "request(s) still owed — journaled for replay at "
                      "the next start", file=sys.stderr)
        tracer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
