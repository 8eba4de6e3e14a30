"""JSONL serving front end — `hyperion_tpu/serve/server.py` in PyTorch,
stdin/stdout transport.

    python -m hyperion_tpu_torch.serve.server --ckpt model.npz \\
        --no-tokenizer < requests.jsonl

One JSON object per line. A request line:
    {"id": "r1", "prompt_ids": [1, 2, 3], "max_new_tokens": 32,
     "temperature": 0.0, "top_k": 0, "top_p": 1.0, "seed": 0,
     "deadline_s": 5.0, "class": "interactive"}
Every response line carries the request id:
    {"id": "r1", "event": "token", "token": 17, "i": 0}
    {"id": "r1", "event": "done", "n_tokens": 32, "ttft_ms": 12.3}
    {"id": "r1", "event": "rejected"|"timed_out", "reason": "..."}
    {"id": null, "event": "error", "error": "..."}   (unparseable line)

The engine loop runs on the main thread and drains on EOF; a reader
thread only submits into the (thread-safe) admission queue. SIGTERM or
SIGINT drains gracefully, a second one stops at once. The engine's
deferred decode paths are flags: `--spec-k`/`--draft`,
`--prefill-chunk`, `--host-cache-mb` (persisted next to the telemetry
stream when one is written), `--brownout*` and `--slo-*`. Not ported
yet: text prompts (the tokenizer), the unix socket, stream resume, the
supervisor and the request journal (ROADMAP A2).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def event_record(ev, tok=None) -> dict | list:
    """TokenEvent -> one wire record (a token line and the terminal line
    when the token finishes the request)."""
    req = ev.request
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
                    "error": "text prompt needs a tokenizer; send prompt_ids"}
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

    def reader():
        try:
            for line in infile:
                try:
                    line = line.strip()
                    if not line:
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hyperion_tpu_torch.serve.server",
        description="continuous-batching inference server over a gathered "
                    "Llama export, JSONL on stdin/stdout, PyTorch/CUDA",
    )
    p.add_argument("--ckpt", required=True,
                   help="gathered-export .npz (written by the trainers)")
    p.add_argument("--no-tokenizer", action="store_true",
                   help="serve raw prompt_ids only; text prompts and the "
                        "tokenizer are not ported yet, so this is required")
    p.add_argument("--max-len", type=int, default=256,
                   help="per-slot KV-cache length: prompt + max_new_tokens "
                        "must fit (also the admission bound)")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent requests decoded per tick")
    p.add_argument("--block-size", type=int, default=16,
                   help="tokens per KV-cache block")
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
                   help="eos token id (default: none)")
    p.add_argument("--device", default="cuda",
                   help="torch device for weights and KV pools (the plain "
                        "PyTorch path runs with --device cpu)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="compute dtype")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="SIGTERM/SIGINT: seconds granted to in-flight and "
                        "queued requests before a hard stop")
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


def main(argv=None, *, device=None) -> int:
    """CLI entry. `device` overrides `--device` for embedded callers."""
    import signal

    from hyperion_tpu_torch import resolve_device
    from hyperion_tpu_torch.checkpoint.io import load_gathered
    from hyperion_tpu_torch.infer.generate import model_from_npz
    from hyperion_tpu_torch.obs import heartbeat as obs_heartbeat
    from hyperion_tpu_torch.obs import trace as obs_trace
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if not args.no_tokenizer:
        print("the tokenizer is not ported yet (ROADMAP A2): pass "
              "--no-tokenizer and send prompt_ids", file=sys.stderr)
        return 2
    dev = resolve_device(device if device is not None else args.device)

    tracer = obs_trace.from_env("data/telemetry.jsonl",
                                run=f"serve_torch_{int(time.time())}")
    hb = obs_heartbeat.Heartbeat.for_tracer(tracer)
    hb.pulse(phase="load")
    with tracer.span("load") as ld:
        model = model_from_npz(load_gathered(args.ckpt), args.max_len,
                               dtype=args.dtype, device=dev)
        ld.set(ckpt=args.ckpt, device=str(dev), dtype=args.dtype)
    # the host tier persists next to the telemetry stream, or nowhere
    host_cache_dir = ""
    if args.host_cache_mb > 0 and tracer.enabled:
        host_cache_dir = str(tracer.path.parent / "hostcache")
    engine = Engine(
        model,
        EngineConfig(
            slots=args.slots, max_len=args.max_len, eos_id=args.eos_id,
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
        tracer=tracer, heartbeat=hb, device=dev,
    )
    hb.pulse(phase="warmup")
    engine.warmup()

    drain_evt = threading.Event()
    hard_evt = threading.Event()

    def _on_signal(signum, frame):
        if drain_evt.is_set():
            hard_evt.set()
        else:
            print(f"[serve] signal {signum}: draining (timeout "
                  f"{args.drain_timeout:.0f}s; signal again to stop now)",
                  file=sys.stderr)
        drain_evt.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread (embedded use): no signal drain

    try:
        serve_jsonl(engine, sys.stdin, sys.stdout, None,
                    {"max_new_tokens": args.max_new_default},
                    drain=drain_evt, drain_timeout_s=args.drain_timeout,
                    hard_stop=hard_evt)
    except KeyboardInterrupt:
        pass
    finally:
        tracer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
