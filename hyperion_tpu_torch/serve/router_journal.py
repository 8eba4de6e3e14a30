"""Router WAL — the write-ahead log that makes the ROUTER as
crash-safe as the replicas it fronts.

Every engine replica keeps a request journal; a replica crash
replays owed work bit-identically and the router's stream-indexed
dedup keeps delivery exactly-once. But the router itself held its
dispatch assignments and high-water marks only in memory: a router
crash stranded every in-flight stream even though the replicas behind
it kept serving. This WAL closes that gap with the same append-only
JSONL + batched-fsync + torn-tail discipline as `serve/journal.py`
(it subclasses `RequestJournal` for exactly that plumbing), with a
router-shaped record vocabulary:

    {"k":"dispatch","id":...,"line":"<original wire line>",
     "replica":R,"session":KEY,"n":REDISPATCHES}
                                       one per (re)dispatch; the FIRST
                                       carries the request's original
                                       wire line — everything a new
                                       router life needs to re-dispatch
    {"k":"hwm","id":...,"i":N}         high-water mark: N tokens
                                       forwarded to the client; appended
                                       and kernel-flushed BEFORE the
                                       client write (fsync batched),
                                       mirroring the replica journal's
                                       journal-before-sink ordering
    {"k":"done","id":...,"outcome":..} terminal (done/rejected/...)
    {"k":"close"}                      clean shutdown — recover nothing

Recovery (`recover()`) returns the orphans: requests with a dispatch
record but no terminal one. Each carries its original wire line, the
last replica it was placed on, its session key, and its journaled
high-water mark. A restarted router re-dispatches them through the
existing seed-deterministic recompute + `StreamDedup` path with the
dedup floor seeded from the mark — the union stream across router
lives stays bit-identical and duplicate-free, the same contract
proved for replica death. (The hwm is written before the client write,
so it can run at most one token AHEAD of what the client actually
received; the client-side `resume {request_id, next_index}` protocol
closes even that window — the client's own index is authoritative
when one reconnects.)

Compaction (`RequestJournal._compact`) applies here too: terminal
streams drop out at recovery when they dominate the file, pending work
preserved byte-exactly.
"""

from __future__ import annotations

import dataclasses
import json

from hyperion_tpu_torch.serve.journal import RequestJournal


@dataclasses.dataclass
class OrphanedDispatch:
    """One in-flight request a dead router life still owes its client."""

    id: str
    line: str            # the original wire line, verbatim
    replica: int | None  # last placement (evidence; re-dispatch re-chooses)
    session: str | None  # affinity key at dispatch time
    hwm: int             # tokens forwarded before the crash
    dispatches: int      # placements so far (failovers included)

    @property
    def doc(self) -> dict | None:
        try:
            doc = json.loads(self.line)
        except (json.JSONDecodeError, TypeError):
            return None
        return doc if isinstance(doc, dict) else None


class RouterJournal(RequestJournal):
    """Append-only router WAL — `RequestJournal`'s write plumbing
    (locked whole-line appends, kernel flush every append, batched
    fsync, OSError degrades instead of crashing, torn final line
    tolerated) under the router's record vocabulary."""

    # ------------------------------------------------------------ write

    def dispatch(self, rid: str, *, line: str, replica: int,
                 session: str | None, n: int = 0,
                 trace: dict | None = None) -> None:
        """One placement decision, durable before the replica sees the
        request. The wire line rides only the first record per request
        (re-dispatches reference it) — the WAL must not grow by the
        prompt length on every failover. The hop context rides every
        record (the stored line stays exactly what the client sent), so
        a WAL post-mortem can cite the same trace ids the fleet trace
        renders."""
        rec = {"k": "dispatch", "id": rid,
               "line": line if n == 0 else None,
               "replica": int(replica), "session": session,
               "n": int(n)}
        if trace is not None:
            rec["trace"] = trace
        self._append(rec, sync=True)

    def hwm(self, rid: str, delivered: int) -> None:
        """High-water mark: `delivered` tokens forwarded. Appended
        ahead of the client write (batched fsync, like `tok`)."""
        self._append({"k": "hwm", "id": rid, "i": int(delivered)},
                     sync=False)

    def done(self, rid: str, outcome: str) -> None:
        self._append({"k": "done", "id": rid, "outcome": outcome},
                     sync=True)

    # ------------------------------------------------------------- read

    def _parse(self):
        """(state_by_id, dispatch_order, clean) — same reader contract
        as the replica journal: torn lines skipped, a `close` marker
        settles everything before it."""
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
                state.clear()
                order.clear()
                clean = True
                continue
            clean = False
            rid = rec.get("id")
            if not rid:
                continue
            st = state.setdefault(
                rid, {"line": None, "replica": None, "session": None,
                      "hwm": 0, "dispatches": 0, "done": None})
            if k == "dispatch":
                if st["dispatches"] == 0:
                    order.append(rid)
                st["dispatches"] += 1
                # a dispatch AFTER a terminal re-opens the request: a
                # client whose wire reset (done "client_gone") resumed
                # it in the same router life
                st["done"] = None
                if rec.get("line") is not None and st["line"] is None:
                    st["line"] = rec["line"]
                st["replica"] = rec.get("replica")
                st["session"] = rec.get("session")
            elif k == "hwm" and rec.get("i") is not None:
                st["hwm"] = max(st["hwm"], int(rec["i"]))
            elif k == "done":
                st["done"] = rec.get("outcome") or "done"
        return state, order, clean

    def recover(self) -> tuple[list[OrphanedDispatch], bool]:
        """Read the WAL; return `(orphans, clean)` — the in-flight
        requests a dead router life still owes, in dispatch order, and
        whether the file ends in a clean close (orphans then empty).
        Terminal-dominated files compact on the way out."""
        state, order, clean = self._parse()
        orphans: list[OrphanedDispatch] = []
        for rid in order:
            st = state[rid]
            if st["done"] is not None or clean or st["line"] is None:
                continue
            rep = st["replica"]
            orphans.append(OrphanedDispatch(
                id=rid, line=st["line"],
                replica=int(rep) if isinstance(rep, int) else None,
                session=st["session"], hwm=int(st["hwm"]),
                dispatches=int(st["dispatches"])))
        self._compact({o.id for o in orphans}, clean=clean)
        return orphans, clean

    def pending_count(self) -> int:
        state, order, clean = self._parse()
        if clean:
            return 0
        return sum(1 for rid in order if state[rid]["done"] is None)

    def tail(self, n: int = 8) -> list[dict]:
        """Last `n` parseable records — the doctor's post-mortem
        evidence (reader-side, works on a dead router's WAL)."""
        try:
            lines = self.path.read_text(encoding="utf-8").splitlines()
        except OSError:
            return []
        out: list[dict] = []
        for line in reversed(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
            if len(out) >= n:
                break
        return list(reversed(out))
