"""Request journal — the write-ahead log that makes `hyperion serve`
crash-safe.

An engine crash without a journal silently loses every queued and
in-flight request: the client hangs, the supervisor restarts an empty
server, and nobody can say what was owed. The journal closes that gap
with an append-only JSONL file recording, per request, exactly what a
restart needs to finish the job:

    {"k":"admit","id":...,"prompt_ids":[...],"max_new_tokens":N,
     "temperature":t,"top_k":k,"top_p":p,"seed":s,"deadline_s":d}
    {"k":"tok","id":...,"tok":N}        one per emitted token
    {"k":"done","id":...,"reason":...}  terminal (eos/budget/timeout/shed)
    {"k":"replay","id":...,"n":K}       appended at recovery, per resume
    {"k":"poisoned","id":...,"n":K}     quarantined by the poison rule
    {"k":"close"}                       clean shutdown — replay nothing

A speculative decode tick (``--spec-k``) can accept several tokens in
one engine step; each still lands as its own `tok` record, in emission
order, before its sink write — the format and the ordering contract
below are tick-shape agnostic, so recovery neither knows nor cares
whether a token came from a sequential or a multi-token tick.

Recovery (`recover()`) replays the file: a request with an `admit` but
no terminal record is *pending* — it is handed back to the engine with
its already-emitted tokens riding along, and resumes through the same
recompute path pool-exhaustion preemption uses (re-prefill prompt +
generated; PR 6): at temperature 0 the continuation is bit-identical
to the run that never crashed, and seeded sampling resumes exactly too
because the PRNG key folds the absolute position, not the wall clock.

**Ordering contract** (why the client stream never duplicates): every
token is journaled *before* its sink write, and every append is
`flush()`ed to the kernel before the sink runs — so any token a client
ever received survives a process kill in the journal, and recovery
never re-computes (hence never re-delivers) a delivered token.
`fsync` is batched (`fsync_every` tokens; admits/terminals sync
eagerly) — a *machine* crash can lose up to one batch window, which
degrades to at-least-once for that window; a *process* crash (the
failure mode the supervisor handles) loses nothing.

**Poison rule**: each recovery appends a `replay` mark per resumed
request. A request found pending with `max_replays` marks already on
file has now crashed the engine that many times in a row — it is
quarantined with a `poisoned` record instead of re-admitted, so one
adversarial request cannot crash-loop the whole replica. Unrelated
crashes do inflate innocent bystanders' counts, which is the
conservative direction: a request that was merely *present* for
`max_replays` crashes is cheap to re-submit, an engine that never
comes up is not.

IO failures degrade, never crash: an append that raises (disk full,
`journal_io_fail@p=X` chaos) disables the journal and records the
error; the engine keeps serving with durability lost, and stamps a
`journal_io_error` event so `obs doctor` can say so.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Callable

import numpy as np

MAX_REPLAYS_DEFAULT = 2


class RequestJournal:
    """Append-only request WAL with batched fsync and crash recovery.

    Single-writer by design (the engine thread owns token/terminal
    appends; `admit` is called under the queue's submit path but the
    file object's `write` is atomic enough for whole small lines and
    every record is self-contained — a torn *final* line is expected
    and tolerated by the reader)."""

    def __init__(self, path: str | Path, *, fsync_every: int = 16,
                 fault: Callable[[str], None] | None = None):
        self.path = Path(path)
        self.fsync_every = max(1, int(fsync_every))
        self._fault = fault
        self._f = None
        self._unsynced = 0
        # admits arrive on front-end threads while the engine thread
        # appends tokens: whole-line appends must never interleave
        self._lock = threading.Lock()
        self.enabled = True
        self.error: str | None = None
        self.clean_closed = False

    # ------------------------------------------------------------ write

    def _append(self, rec: dict, sync: bool) -> None:
        if not self.enabled:
            return
        try:
            with self._lock:
                if self._fault is not None:
                    self._fault("journal_append")
                if self._f is None:
                    self.path.parent.mkdir(parents=True, exist_ok=True)
                    self._f = self.path.open("a", encoding="utf-8")
                self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                # flush to the KERNEL on every append: a SIGKILL'd
                # process loses user-space buffers, not kernel ones —
                # this line is what makes journal-before-sink mean
                # "delivered implies durable" under process kills
                self._f.flush()
                self._unsynced += 1
                if sync or self._unsynced >= self.fsync_every:
                    os.fsync(self._f.fileno())
                    self._unsynced = 0
        except OSError as e:
            # durability degrades; the serve loop must not die of it
            self.enabled = False
            self.error = str(e)

    def admit(self, req) -> None:
        """Record an accepted request — durable before its first token
        can reference it. Sampling params and the seed ride along so a
        replay reconstructs the identical PRNG stream."""
        rec = {
            "k": "admit", "id": req.id,
            "prompt_ids": np.asarray(req.prompt_ids).tolist(),
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k), "top_p": float(req.top_p),
            "seed": int(req.seed),
            "deadline_s": (float(req.deadline_s)
                           if req.deadline_s is not None else None),
        }
        if getattr(req, "trace", None):
            # the fleet hop context survives a crash with the request,
            # so a replayed request's events still join the fleet trace
            rec["trace"] = req.trace
        self._append(rec, sync=True)

    def token(self, rid: str, tok: int) -> None:
        self._append({"k": "tok", "id": rid, "tok": int(tok)}, sync=False)

    def finish(self, rid: str, reason: str) -> None:
        self._append({"k": "done", "id": rid, "reason": reason}, sync=True)

    def close_clean(self) -> None:
        """Clean-shutdown marker: a restart after this replays nothing
        (and asserts nothing was owed)."""
        self._append({"k": "close"}, sync=True)
        self.clean_closed = True
        self.close()

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
            except OSError:
                pass
            self._f = None

    # ------------------------------------------------------------ compact

    def _compact(self, live_ids: set[str], clean: bool = False) -> bool:
        """Rewrite the journal keeping only the current life's records
        of `live_ids`, byte-exactly, when more than half the records on
        file are dead weight (terminal requests, settled pre-close
        history, torn lines). Atomic: the kept lines land in a sibling
        temp file that `os.replace`s the journal, so a crash mid-compact
        leaves either the old file or the new one, never a torn hybrid.
        Called at recovery — supervised restarts otherwise grow the WAL
        forever with requests nobody will ever replay again."""
        try:
            with self._lock:
                if self._f is not None:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                    self._f.close()
                    self._f = None
                try:
                    lines = self.path.read_text(
                        encoding="utf-8").splitlines(keepends=True)
                except OSError:
                    return False
                keep: list[str] = []
                total = 0
                for line in lines:
                    s = line.strip()
                    if not s:
                        continue
                    total += 1
                    try:
                        rec = json.loads(s)
                    except json.JSONDecodeError:
                        continue  # torn line: never worth carrying over
                    if not isinstance(rec, dict):
                        continue
                    if rec.get("k") == "close":
                        # settled history: everything before a close is
                        # done with — a compact starts the file at the
                        # current life
                        keep.clear()
                        continue
                    if rec.get("id") in live_ids:
                        keep.append(line if line.endswith("\n")
                                    else line + "\n")
                if clean and not keep:
                    # a clean-closed file compacts to just the close
                    # marker: "nothing owed because cleanly shut down"
                    # must stay distinguishable from "no journal at all"
                    keep = ['{"k":"close"}\n']
                if total == 0 or (total - len(keep)) * 2 <= total:
                    return False
                tmp = self.path.with_name(self.path.name + ".compact")
                with tmp.open("w", encoding="utf-8") as f:
                    f.writelines(keep)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                return True
        except OSError as e:
            # compaction is an optimization: failing it degrades to the
            # old ever-growing file, never to a lost journal
            self.error = str(e)
            return False

    # ------------------------------------------------------------- read

    def _parse(self) -> tuple[dict, list[str], bool]:
        """(state_by_id, admit_order, clean) from the file as it
        stands. A torn final line (the record a killed process never
        finished) is skipped silently; a torn middle line is counted
        but must not abort recovery — every record is independent."""
        state: dict[str, dict] = {}
        order: list[str] = []
        clean = False
        try:
            lines = self.path.read_text(encoding="utf-8").splitlines()
        except OSError:
            return {}, [], False
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write — the crash signature itself
            if not isinstance(rec, dict):
                continue
            k = rec.get("k")
            if k == "close":
                # clean shutdown: everything before it is settled
                # history. Drop it — a later life reusing a request id
                # must not inherit the old life's done marker (which
                # would silently skip its replay) or its token list
                # (which would corrupt the resume payload).
                state.clear()
                order.clear()
                clean = True
                continue
            clean = False  # records after a close: a new serving life
            rid = rec.get("id")
            if not rid:
                continue
            st = state.setdefault(
                rid, {"admit": None, "tokens": [], "done": None,
                      "replays": 0, "poisoned": False})
            if k == "admit":
                if st["admit"] is None:
                    order.append(rid)
                st["admit"] = rec
            elif k == "tok" and rec.get("tok") is not None:
                st["tokens"].append(int(rec["tok"]))
            elif k == "done":
                st["done"] = rec.get("reason") or "done"
            elif k == "replay":
                st["replays"] = max(st["replays"], int(rec.get("n") or 0))
            elif k == "poisoned":
                st["poisoned"] = True
        return state, order, clean

    def recover(self, *, max_replays: int = MAX_REPLAYS_DEFAULT,
                eos_id: int | None = None):
        """Read the journal and mark this recovery on it.

        Returns `(resume, finished, poisoned, clean)`:
          * `resume`   — Requests (admit order) still owed work; each
            carries its journaled tokens (the recompute-resume payload)
            and a `replay` mark has been appended for it.
          * `finished` — Requests whose output was already complete
            (budget reached / eos emitted) but whose terminal record
            was lost to the crash: nothing to compute, the caller just
            owes the client a `done`.
          * `poisoned` — Requests quarantined by the poison rule
            (`max_replays` prior replays, still unfinished); a
            `poisoned` record has been appended so later recoveries
            skip them permanently.
          * `clean`    — the file ends in a clean close (resume and
            poisoned are then necessarily empty).
        """
        from hyperion_tpu_torch.serve.queue import Request

        state, order, clean = self._parse()
        resume: list = []
        finished: list = []
        poisoned: list = []
        for rid in order:
            st = state[rid]
            if st["done"] is not None or st["poisoned"] or clean:
                continue
            a = st["admit"]
            req = Request(
                prompt_ids=np.asarray(a["prompt_ids"], np.int32),
                max_new_tokens=int(a["max_new_tokens"]),
                id=rid,
                temperature=float(a.get("temperature") or 0.0),
                top_k=int(a.get("top_k") or 0),
                top_p=float(a.get("top_p") if a.get("top_p") is not None
                            else 1.0),
                seed=int(a.get("seed") or 0),
                # the original wall deadline died with the old process;
                # a replayed request gets its deadline re-anchored to
                # re-admission — a second chance, not a free pass
                deadline_s=a.get("deadline_s"),
                trace=(a["trace"] if isinstance(a.get("trace"), dict)
                       else None),
            )
            req.tokens = list(st["tokens"])
            req.replays = st["replays"]
            complete = (
                len(req.tokens) >= req.max_new_tokens
                or (eos_id is not None and req.tokens
                    and req.tokens[-1] == eos_id)
            )
            if complete:
                finished.append(req)
                self.finish(rid, "recovered_complete")
            elif st["replays"] >= max_replays:
                poisoned.append(req)
                self._append({"k": "poisoned", "id": rid,
                              "n": st["replays"]}, sync=True)
            else:
                req.replays += 1
                self._append({"k": "replay", "id": rid,
                              "n": req.replays}, sync=True)
                resume.append(req)
        # compact AFTER the recovery marks: terminal requests (including
        # the finish/poisoned records just appended) drop out; the
        # resumed requests' admit/tok/replay history survives byte-exact
        self._compact({req.id for req in resume}, clean=clean)
        return resume, finished, poisoned, clean

    def pending_count(self) -> int:
        """Unfinished admitted requests on file right now (reader-side
        convenience for tests and the drain assertion: a cleanly
        drained journal owes nothing)."""
        state, order, clean = self._parse()
        if clean:
            return 0
        return sum(1 for rid in order
                   if state[rid]["done"] is None
                   and not state[rid]["poisoned"])
