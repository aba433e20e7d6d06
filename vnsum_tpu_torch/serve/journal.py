"""Write-ahead request journal: crash-safe at-least-once serving.

The supervisor makes the serving stack survive in-process failures; a
process death would still lose every accepted-but-unfinished request.
This module is the durability layer: every :class:`~.queue.ServeRequest` admission writes
an ACCEPT record carrying the FULL request payload (prompt, decoding config
incl. seed, reference, cache hint, wall-clock deadline) before any engine
work happens, and the request's lifecycle appends START / COMPLETE / FAILED
transitions. On restart the journal is replayed: ACCEPTed-but-incomplete
requests re-enqueue through the normal supervised path (greedy decoding is
deterministic, so replays are byte-identical to an uninterrupted run),
COMPLETEd ones serve their recorded result to reconnecting clients
(``GET /v1/requests/<id>``), and the ledger invariant holds — every
journaled ACCEPT ends COMPLETE or typed FAILED, never lost
(testing/chaos.py SIGKILLs a live server to prove it).

Storage format — append-only JSONL segments in one directory::

    journal.000001.jsonl        # sealed or compacted history
    journal.000002.jsonl        # the active segment (appends + fsync)

Each line is ``<crc32-hex8> <json>\\n`` with the CRC computed over the JSON
bytes: recovery verifies every record and drops a torn tail (the partial
line a kill mid-write leaves) instead of propagating garbage. Segments
rotate at ``max_segment_bytes``; on every reopen the whole journal is
COMPACTED — live state is rewritten into a fresh segment via write-temp +
``os.replace`` (crash-atomic: either the old segments or the complete new
one exist, never a half file) and the old segments are deleted, so the
journal's size is bounded by live state + one rotation window, not by
lifetime traffic.

Durability model, in order of what each write survives:

- ``write()+flush()`` per record -> survives **SIGKILL / process death**
  (the bytes are in the kernel page cache; only the machine losing power
  can drop them). This is the per-append cost — microseconds.
- batched ``fsync`` every ``fsync_interval_s`` (group commit, issued from
  the scheduler thread's appends, never the admission path) -> bounds the
  **power-loss** window without paying an fsync per request.
- ``seal()`` + compaction fsync + directory fsync -> clean-shutdown markers
  and renames are fully durable.

Threading: one internal lock (``make_lock("serve.journal")``); the queue
lock may be held while appending (the admission hook), so the journal lock
is always innermost — consistent with the lock-order sanitizer's graph.

Copy of ``vnsum_tpu/serve/journal.py``; only the imports, the CLI's program
name and this paragraph differ. The record format is the JAX package's byte
for byte (same ``_encode``, same field order, the QoS class ``tenant`` /
``tier`` written only when it is not the default), so a journal either
package writes replays in the other with its QoS class intact.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

from ..analysis.sanitizers import make_lock
from ..core.artifacts import fsync_dir
from ..core.logging import get_logger
from ..obs.trace import emit
from ..testing.faults import fault

logger = get_logger("vnsum.serve.journal")

# record events; ACCEPT carries the replayable payload, COMPLETE the result
EV_ACCEPT = "accept"
EV_START = "start"
EV_COMPLETE = "complete"
EV_FAILED = "failed"
EV_SEAL = "seal"
# typed terminal cancellation (serve/scheduler.py cancel paths): the client
# withdrew the request (DELETE /v1/requests/<id>) or stopped listening
# (stream disconnect past the resume window). TERMINAL like COMPLETE/FAILED
# — compaction preserves it and restart replay never resurrects a cancelled
# request (the ledger invariant counts it as resolved, not lost)
EV_CANCELLED = "cancelled"
# QoS lifecycle (serve/qos.py + serve/inflight.py): PREEMPTED marks a
# batch-tier request evicted from its decode slot, REQUEUED its re-entry
# into the queue (both non-terminal — the ACCEPT payload stays replayable,
# so a crash anywhere in the preempt->requeue window still replays the
# request to exactly one terminal state); STREAMING marks a request whose
# first SSE delta left the server
EV_PREEMPT = "preempted"
EV_REQUEUE = "requeued"
EV_STREAM = "streaming"
# structured jobs (serve/gang.py): a GANG record is group METADATA, not a
# request lifecycle event — ``rid`` is the gang id and ``members`` lists
# (child_rid, phase) pairs admitted since the last flush, so restart replay
# reconstructs group membership (and the /v1/requests per-phase progress
# view) without inferring it from rid prefixes. A GANG record with
# ``partial: true`` marks the group degraded: a member failed typed POISON
# and the reduce proceeded without it
EV_GANG = "gang"

# the non-terminal lifecycle states compaction must preserve (a preempted
# entry that compacts to a bare ACCEPT would lie to GET /v1/requests/<id>)
_NONTERMINAL_STATES = (EV_START, EV_PREEMPT, EV_REQUEUE, EV_STREAM)

_SEGMENT_PREFIX = "journal."
_SEGMENT_SUFFIX = ".jsonl"


@dataclass
class JournalEntry:
    """In-memory state of one journaled request."""

    rid: str
    status: str = EV_ACCEPT  # accept -> start -> complete|failed
    payload: dict = field(default_factory=dict)
    text: str | None = None
    gen_tokens: int = 0
    reason: str = ""
    detail: str = ""

    @property
    def terminal(self) -> bool:
        return self.status in (EV_COMPLETE, EV_FAILED, EV_CANCELLED)

    def to_dict(self) -> dict:
        d = {"rid": self.rid, "status": self.status}
        if self.status == EV_COMPLETE:
            d["text"] = self.text
            d["generated_tokens"] = self.gen_tokens
        elif self.status in (EV_FAILED, EV_CANCELLED):
            d["reason"] = self.reason
            d["detail"] = self.detail
        return d


def _encode(record: dict) -> bytes:
    body = json.dumps(record, ensure_ascii=False,
                      separators=(",", ":")).encode("utf-8")
    return b"%08x " % zlib.crc32(body) + body + b"\n"


def _decode(line: bytes) -> dict | None:
    """One journal line -> record dict, or None when torn/corrupt (bad CRC,
    truncated, malformed JSON)."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    body = line[9:]
    try:
        if int(line[:8], 16) != zlib.crc32(body):
            return None
        return json.loads(body)
    # lint-allow[swallowed-exception]: returning None IS the answer — the caller counts the record as torn and stops trusting the segment
    except (ValueError, UnicodeDecodeError):
        return None


def request_payload(req) -> dict:
    """The replayable payload of a ServeRequest: everything submit() needs
    to reconstruct it byte-identically (greedy) after a restart. Monotonic
    deadlines don't survive a process, so the remaining budget is stored as
    a wall-clock instant."""
    import dataclasses

    cfg = None
    if req.config is not None:
        cfg = dataclasses.asdict(req.config)
        cfg["eos_ids"] = list(cfg.get("eos_ids") or ())
    deadline_unix = None
    if req.deadline is not None:
        deadline_unix = time.time() + (req.deadline - time.monotonic())
    payload = {
        "prompt": req.prompt,
        "max_new_tokens": req.max_new_tokens,
        "config": cfg,
        "reference": req.reference,
        "cache_hint": req.cache_hint,
        "trace_id": req.trace_id,
        "deadline_unix": deadline_unix,
    }
    # QoS class survives restart: a replayed batch-tier request must stay
    # evictable and keep billing its tenant (omitted when default so old
    # journals and the common single-tenant case stay byte-compatible)
    if req.tenant:
        payload["tenant"] = req.tenant
    if req.tier != "interactive":
        payload["tier"] = req.tier
    # structured-job membership survives restart: a replayed gang member
    # must rejoin its group (affinity pick, whole-gang preemption, per-phase
    # progress) instead of replaying as an unrelated request (omitted when
    # ungrouped so old journals stay byte-compatible)
    gang_id = getattr(req, "gang_id", "")
    if gang_id:
        payload["gang"] = gang_id
        if getattr(req, "gang_phase", ""):
            payload["gang_phase"] = req.gang_phase
    # router-journaled summarize requests carry the strategy name so a
    # handoff replays them through /v1/summarize, not /v1/generate; engine
    # ServeRequests have no such attribute and stay byte-compatible
    approach = getattr(req, "approach", None)
    if approach:
        payload["approach"] = approach
    return payload


class RequestJournal:
    """Append-only request ledger over JSONL segments in ``directory``.

    Opening recovers existing state (CRC-checked, torn tails dropped) and
    compacts it into a fresh segment; the instance then appends lifecycle
    records until :meth:`seal`/:meth:`close`. ``keep_terminal`` bounds the
    in-memory (and post-compaction) history of finished requests — the
    oldest terminal entries are evicted first, so a long-lived server's
    ledger holds recent history plus ALL unfinished work, never unbounded
    lifetime traffic.
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        fsync_interval_s: float = 0.05,
        max_segment_bytes: int = 4 << 20,
        keep_terminal: int = 4096,
    ) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.fsync_interval_s = float(fsync_interval_s)
        self.max_segment_bytes = int(max_segment_bytes)
        self.keep_terminal = int(keep_terminal)
        # lock-order-sanitizer hook: the queue lock may be held while
        # acquiring this one (admission hook); this lock is always innermost
        self._lock = make_lock("serve.journal")
        self._entries: OrderedDict[str, JournalEntry] = OrderedDict()  # guarded by: _lock
        self._trace_counts: dict[str, int] = {}   # guarded by: _lock
        self._replayed: set[str] = set()          # guarded by: _lock
        self._file = None                         # guarded by: _lock
        self._seg_bytes = 0                       # guarded by: _lock
        self._last_sync = time.monotonic()        # guarded by: _lock
        self._closed = False                      # guarded by: _lock
        # monotone counters for /metrics (racy scrape reads are fine)
        self.records = 0
        self.appended_bytes = 0
        self.fsyncs = 0
        self.rotations = 0
        self.torn_records = 0
        self.replayed_total = 0
        self.replay_seconds = 0.0
        self.recovered_sealed = False

        state, seq, sealed, torn, gangs = _read_directory(self.directory)
        self._entries = state
        # structured-job group metadata (serve/gang.py), rebuilt from GANG
        # records at recovery: {gang_id: {"members": {rid: phase},
        # "partial": bool}}            # guarded by: _lock
        self._gangs = gangs
        # running count of terminal entries so completion-path eviction is
        # O(1) except when actually evicting     # guarded by: _lock
        self._terminal = sum(1 for e in state.values() if e.terminal)
        self.torn_records = torn
        self.recovered_sealed = sealed
        for rid in state:
            base, _, n = rid.partition("#")
            cur = self._trace_counts.get(base, 0)
            self._trace_counts[base] = max(cur, int(n) + 1 if n else 1)
        self._seq = seq + 1
        self._compact_locked()

    # -- segment plumbing (all *_locked run under self._lock) -------------

    def _segment_path(self, seq: int) -> Path:
        return self.directory / f"{_SEGMENT_PREFIX}{seq:06d}{_SEGMENT_SUFFIX}"

    def _open_segment_locked(self) -> None:
        path = self._segment_path(self._seq)
        self._file = open(path, "ab")
        self._seg_bytes = path.stat().st_size

    # durable
    def _compact_locked(self) -> None:
        """Rewrite live state into a fresh segment (write-temp + fsync +
        ``os.replace`` + directory fsync — crash-atomic), then delete the
        old segments and start appending to the compacted one."""
        self._evict_terminal_locked()
        old = _segment_paths(self.directory)
        path = self._segment_path(self._seq)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            for entry in self._entries.values():
                f.write(_encode({"e": EV_ACCEPT, "rid": entry.rid,
                                 **entry.payload}))
                if entry.status == EV_COMPLETE:
                    f.write(_encode({"e": EV_COMPLETE, "rid": entry.rid,
                                     "text": entry.text,
                                     "gen": entry.gen_tokens}))
                elif entry.status == EV_FAILED:
                    f.write(_encode({"e": EV_FAILED, "rid": entry.rid,
                                     "reason": entry.reason,
                                     "detail": entry.detail}))
                elif entry.status == EV_CANCELLED:
                    # compaction-safe: a cancelled entry must stay CANCELLED
                    # across reopens — compacting it to a bare ACCEPT would
                    # resurrect it at the next restart replay
                    f.write(_encode({"e": EV_CANCELLED, "rid": entry.rid,
                                     "reason": entry.reason}))
                elif entry.status in _NONTERMINAL_STATES:
                    # preserve mid-lifecycle state (start / preempted /
                    # requeued / streaming) so the poll surface stays
                    # honest across a compacting reopen; the entry still
                    # replays from its ACCEPT payload either way
                    f.write(_encode({"e": entry.status, "rid": entry.rid}))
            # structured-job metadata rides compaction too: a gang whose
            # members were all evicted has nothing left to describe — drop
            # it so gang metadata is bounded by live history like entries
            self._gangs = {
                gid: meta for gid, meta in self._gangs.items()
                if any(r in self._entries for r in meta["members"])
            }
            for gid, meta in self._gangs.items():
                rec = {"e": EV_GANG, "rid": gid,
                       "members": [[r, p] for r, p in meta["members"].items()]}
                if meta.get("partial"):
                    rec["partial"] = True
                f.write(_encode(rec))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(self.directory)
        for p in old:
            if p != path:
                p.unlink(missing_ok=True)
        self._open_segment_locked()

    def _rotate_locked(self) -> None:
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._seq += 1
        self.rotations += 1
        self.fsyncs += 1
        self._last_sync = time.monotonic()
        self._open_segment_locked()

    def _append_locked(self, record: dict, allow_sync: bool) -> None:
        if self._closed:
            return
        raw = _encode(record)
        self._file.write(raw)
        # flush to the KERNEL on every record: this is what makes a SIGKILL
        # lose nothing — fsync below only narrows the power-loss window
        self._file.flush()
        self._seg_bytes += len(raw)
        self.records += 1
        self.appended_bytes += len(raw)
        if not allow_sync:
            # admission path (queue lock held): flush-to-kernel only — no
            # fsync and no rotation here; the next scheduler-thread append
            # settles both (the segment overshoots its bound by at most the
            # accepts that land between two lifecycle appends)
            return
        if self._seg_bytes >= self.max_segment_bytes:
            self._rotate_locked()
            return  # rotation just fsynced
        now = time.monotonic()
        if now - self._last_sync >= self.fsync_interval_s:
            # seeded injection point (vnsum_tpu_torch.testing.faults, site
            # `journal.fsync`): a `hang` here wedges the scheduler thread
            # INSIDE the journal lock with no dispatch ticket armed — the
            # watchdog's lock-classified stall, which must escalate to
            # seal-and-exit (a replacement thread would deadlock on this
            # very lock). Free when disarmed
            fault("journal.fsync")
            os.fsync(self._file.fileno())
            self.fsyncs += 1
            self._last_sync = now
            emit("journal_sync", now, time.monotonic() - now)

    def _evict_terminal_locked(self) -> None:
        excess = self._terminal - self.keep_terminal
        if excess <= 0:
            return
        for rid in [r for r, e in self._entries.items() if e.terminal][:excess]:
            del self._entries[rid]
        self._terminal -= excess

    # -- lifecycle appends -------------------------------------------------

    def accept(self, req) -> str:
        """Journal one admitted ServeRequest; assigns and returns its
        journal id. Idempotent per id: a request re-submitted at replay
        carries its original ``journal_rid`` and is NOT journaled twice —
        the replay-idempotence property (replaying twice enqueues once
        rides on the caller checking :meth:`take_unfinished`).

        Runs under the queue lock (the admission hook), so this path never
        fsyncs — flush-to-kernel only; group commit happens on the
        scheduler thread's lifecycle appends."""
        with self._lock:
            rid = req.journal_rid
            if rid is not None and rid in self._entries:
                return rid
            if rid is None:
                base = req.trace_id
                n = self._trace_counts.get(base, 0)
                self._trace_counts[base] = n + 1
                rid = base if n == 0 else f"{base}#{n}"
                req.journal_rid = rid
            payload = request_payload(req)
            self._entries[rid] = JournalEntry(rid=rid, payload=payload)
            self._append_locked({"e": EV_ACCEPT, "rid": rid, **payload},
                                allow_sync=False)
            return rid

    def start(self, rid: str) -> None:
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None or entry.terminal:
                return
            entry.status = EV_START
            self._append_locked({"e": EV_START, "rid": rid}, allow_sync=True)

    def _lifecycle_locked(self, rid: str, event: str) -> None:
        """One non-terminal lifecycle transition (preempted / requeued /
        streaming): status update + append, scheduler-thread paths only."""
        entry = self._entries.get(rid)
        if entry is None or entry.terminal:
            return
        entry.status = event
        self._append_locked({"e": event, "rid": rid}, allow_sync=True)

    def preempt(self, rid: str) -> None:
        """The typed PREEMPTED event: the request's slot was evicted for
        higher-priority work; its ACCEPT payload remains the replayable
        source of truth (a crash before the matching REQUEUE still replays
        it — the mid-preemption chaos kill point proves this)."""
        with self._lock:
            self._lifecycle_locked(rid, EV_PREEMPT)

    def requeue(self, rid: str) -> None:
        with self._lock:
            self._lifecycle_locked(rid, EV_REQUEUE)

    def streaming(self, rid: str) -> None:
        """First SSE delta left the server for this request."""
        with self._lock:
            self._lifecycle_locked(rid, EV_STREAM)

    def gang(self, gang_id: str, members: list[tuple[str, str]]) -> None:
        """Journal one structured-job membership flush (serve/gang.py):
        ``members`` is the (child_rid, phase) batch admitted since the last
        flush — one record per fan-out round, not per member, so a 40-chunk
        map round costs one append. Idempotent per member (replay-safe:
        a re-flushed member just overwrites its phase)."""
        if not members:
            return
        with self._lock:
            meta = self._gangs.setdefault(
                gang_id, {"members": {}, "partial": False}
            )
            meta["members"].update(members)
            self._append_locked(
                {"e": EV_GANG, "rid": gang_id,
                 "members": [[r, p] for r, p in members]},
                allow_sync=True,
            )

    def gang_partial(self, gang_id: str, reason: str = "poison") -> None:
        """Mark a gang DEGRADED: a member failed typed POISON and the reduce
        proceeded without its output. Journaled so a restarted server's
        /v1/requests view still distinguishes a degraded summary from a
        complete one. Idempotent."""
        with self._lock:
            meta = self._gangs.setdefault(
                gang_id, {"members": {}, "partial": False}
            )
            if meta["partial"]:
                return
            meta["partial"] = True
            self._append_locked(
                {"e": EV_GANG, "rid": gang_id, "partial": True,
                 "reason": reason},
                allow_sync=True,
            )

    def gang_info(self, gang_id: str) -> dict | None:
        """Group metadata for the poll surface: {"members": {rid: phase},
        "partial": bool} or None when the id never flushed a gang."""
        with self._lock:
            meta = self._gangs.get(gang_id)
            if meta is None:
                return None
            return {"members": dict(meta["members"]),
                    "partial": bool(meta["partial"])}

    def gangs_unfinished(self) -> dict[str, dict]:
        """Gangs with at least one non-terminal member — what startup
        replay hands the GangRegistry so replayed members rejoin their
        groups."""
        with self._lock:
            out = {}
            for gid, meta in self._gangs.items():
                live = any(
                    (e := self._entries.get(r)) is not None and not e.terminal
                    for r in meta["members"]
                )
                if live:
                    out[gid] = {"members": dict(meta["members"]),
                                "partial": bool(meta["partial"])}
            return out

    def complete(self, rid: str, text: str, gen_tokens: int = 0) -> None:
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None or entry.terminal:
                return
            entry.status = EV_COMPLETE
            entry.text = text
            entry.gen_tokens = int(gen_tokens)
            self._terminal += 1
            self._append_locked(
                {"e": EV_COMPLETE, "rid": rid, "text": text,
                 "gen": int(gen_tokens)}, allow_sync=True,
            )
            self._evict_terminal_locked()

    def fail(self, rid: str, reason: str, detail: str = "") -> None:
        """Typed terminal failure — sheds and supervised give-ups both land
        here; the ledger invariant counts them as resolved, not lost."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None or entry.terminal:
                return
            entry.status = EV_FAILED
            entry.reason = reason
            entry.detail = detail[:500]
            self._terminal += 1
            self._append_locked(
                {"e": EV_FAILED, "rid": rid, "reason": reason,
                 "detail": entry.detail}, allow_sync=True,
            )
            self._evict_terminal_locked()

    def cancel(self, rid: str, reason: str = "api") -> None:
        """Typed terminal CANCELLED — the client withdrew the request or
        stopped listening. Terminal like fail(): the ledger invariant
        counts it resolved, replay skips it, and (like every terminal
        append) it no-ops on an already-terminal entry, which is what makes
        DELETE idempotent against completion races."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None or entry.terminal:
                return
            entry.status = EV_CANCELLED
            entry.reason = reason
            self._terminal += 1
            self._append_locked(
                {"e": EV_CANCELLED, "rid": rid, "reason": reason},
                allow_sync=True,
            )
            self._evict_terminal_locked()

    def sync(self) -> None:
        """Force the batched fsync now."""
        with self._lock:
            if self._file is not None and not self._closed:
                t0 = time.monotonic()
                fault("journal.fsync")
                os.fsync(self._file.fileno())
                self.fsyncs += 1
                self._last_sync = time.monotonic()
                emit("journal_sync", t0, self._last_sync - t0)

    def seal(self) -> None:
        """Clean-shutdown marker: append SEAL and fsync. A journal whose
        last record is SEAL recovered with zero unfinished entries came
        from a graceful drain."""
        with self._lock:
            if self._closed:
                return
            self._append_locked({"e": EV_SEAL, "t": time.time()},
                                allow_sync=False)
            os.fsync(self._file.fileno())
            self.fsyncs += 1

    def close(self) -> None:
        with self._lock:
            if self._file is not None and not self._closed:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
            self._closed = True

    # -- recovery / introspection -----------------------------------------

    def take_unfinished(self) -> list[JournalEntry]:
        """Entries accepted (or started) but not terminal, each returned AT
        MOST ONCE per process — the replay source. Marking them replayed
        in-memory is what makes calling replay twice enqueue once."""
        with self._lock:
            out = [
                e for e in self._entries.values()
                if not e.terminal and e.rid not in self._replayed
            ]
            self._replayed.update(e.rid for e in out)
            return out

    def note_replay(self, n: int, seconds: float) -> None:
        self.replayed_total += n
        self.replay_seconds += seconds

    def lookup(self, rid: str) -> list[JournalEntry]:
        """The poll surface (``GET /v1/requests/<id>``): the entry named
        ``rid`` plus any fan-out children ``rid#N``."""
        prefix = rid + "#"
        with self._lock:
            return [
                e for r, e in self._entries.items()
                if r == rid or r.startswith(prefix)
            ]

    def pending(self) -> int:
        with self._lock:
            return len(self._entries) - self._terminal

    def stats_dict(self) -> dict:
        """Scrape-time counters for /metrics (vnsum_serve_journal_*)."""
        return {
            "records": self.records,
            "appended_bytes": self.appended_bytes,
            "fsyncs": self.fsyncs,
            "rotations": self.rotations,
            "torn_records": self.torn_records,
            "replayed": self.replayed_total,
            "replay_seconds": round(self.replay_seconds, 6),
            "pending": self.pending(),
        }

    @staticmethod
    def read_state(directory: str | Path):
        """Read-only ledger view: (entries, sealed, torn_records) without
        opening the journal for writing or compacting — what the chaos-soak
        harness audits after the final shutdown."""
        entries, _seq, sealed, torn, _gangs = _read_directory(Path(directory))
        return entries, sealed, torn

    @staticmethod
    def read_gangs(directory: str | Path) -> dict[str, dict]:
        """Read-only structured-job view: {gang_id: {"members":
        {rid: phase}, "partial": bool}} — the chaos-soak gang audit's
        membership source (every admitted gang must fold to a terminal
        parent aggregate)."""
        _entries, _seq, _sealed, _torn, gangs = _read_directory(
            Path(directory)
        )
        return gangs


def aggregate_status(entries: list[JournalEntry]) -> str:
    """Fold one request's ledger entries (the id plus its ``#N`` fan-out
    children) into the ONE client-facing status — shared by
    ``GET /v1/requests/<id>`` and the ``DELETE`` cancel surface so the two
    can never disagree.

    Entries under one id are either RETRIES of one payload (same prompt —
    client re-submitted after a crash, at-least-once) or FAN-OUT siblings
    (different prompts). For retries any COMPLETE means the request
    succeeded, whatever a replayed duplicate did; for fan-out a failed
    child fails the request, and a cancelled child (with everyone else
    already terminal) marks the gang cancelled. Mid-lifecycle precedence
    (QoS + streaming states): any child actively on the engine
    (streaming > started) outranks one parked by preemption
    (requeued > preempted) — the aggregate answers "is anything moving",
    not "is everything moving"."""
    statuses = {e.status for e in entries}
    same_payload = len({e.payload.get("prompt") for e in entries}) == 1
    if same_payload and EV_COMPLETE in statuses:
        return "completed"
    if EV_FAILED in statuses:
        if (
            not same_payload
            and EV_COMPLETE in statuses
            and all(e.terminal for e in entries)
        ):
            # degraded fan-out (serve/gang.py): a member failed typed
            # POISON but the gang delivered a reduce over the survivors —
            # terminal, yet the client must be able to tell this summary
            # from a complete one. Gated on all-terminal: while siblings
            # are still moving the fold keeps reporting "failed" (the
            # pre-gang contract) and flips to "partial" only once the
            # degraded result actually exists
            return "partial"
        return "failed"
    if statuses == {EV_COMPLETE}:
        return "completed"
    if (
        EV_CANCELLED in statuses
        and statuses <= {EV_CANCELLED, EV_COMPLETE}
    ):
        # the gang is fully terminal with at least one cancel: the request
        # was withdrawn. A still-moving sibling falls through to the
        # mid-lifecycle states below instead (cancel is in flight)
        return "cancelled"
    if EV_STREAM in statuses:
        return "streaming"
    if EV_START in statuses or EV_COMPLETE in statuses:
        return "started"  # partial progress across fan-out
    if EV_REQUEUE in statuses:
        return "requeued"  # preempted, back in the queue
    if EV_PREEMPT in statuses:
        return "preempted"  # evicted, requeue not yet journaled
    return "accepted"


# -- directory scan ----------------------------------------------------------


def _segment_paths(directory: Path) -> list[Path]:
    out = []
    for p in directory.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}"):
        try:
            int(p.name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
        # lint-allow[swallowed-exception]: a non-numeric name simply is not a segment; skipping it is the resolution
        except ValueError:
            continue
        out.append(p)
    return sorted(out)


def _read_directory(directory: Path):
    """Replay every segment -> (entries, max_seq, sealed, torn_records,
    gangs).

    A record that fails CRC/decode stops the read of ITS segment (everything
    after an unverifiable record is untrusted), which covers the torn-tail
    case a kill mid-append leaves; earlier records and later segments are
    unaffected."""
    entries: OrderedDict[str, JournalEntry] = OrderedDict()
    gangs: dict[str, dict] = {}
    max_seq = 0
    sealed = False
    torn = 0
    for path in _segment_paths(directory):
        max_seq = max(
            max_seq,
            int(path.name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]),
        )
        data = path.read_bytes()
        for line in data.split(b"\n"):
            if not line:
                continue
            rec = _decode(line)
            if rec is None:
                torn += 1
                logger.warning(
                    "journal %s: dropping torn/corrupt record (and the "
                    "rest of the segment)", path.name,
                )
                break
            sealed = _apply(entries, rec, gangs)
    return entries, max_seq, sealed, torn, gangs


def _apply(entries: OrderedDict, rec: dict, gangs: dict | None = None) -> bool:
    """Fold one record into the state map; returns the new sealed flag
    (True only when THIS record is a seal — any later record unseals)."""
    ev = rec.get("e")
    if ev == EV_SEAL:
        return True
    rid = rec.get("rid")
    if not isinstance(rid, str):
        return False
    if ev == EV_GANG:
        if gangs is not None:
            meta = gangs.setdefault(rid, {"members": {}, "partial": False})
            for pair in rec.get("members") or []:
                if isinstance(pair, list) and len(pair) == 2:
                    meta["members"][str(pair[0])] = str(pair[1])
            if rec.get("partial"):
                meta["partial"] = True
        return False
    if ev == EV_ACCEPT:
        if rid not in entries:
            payload = {k: v for k, v in rec.items() if k not in ("e", "rid")}
            entries[rid] = JournalEntry(rid=rid, payload=payload)
    elif ev in _NONTERMINAL_STATES:
        entry = entries.get(rid)
        if entry is not None and not entry.terminal:
            entry.status = ev
    elif ev == EV_COMPLETE:
        entry = entries.get(rid)
        if entry is not None and not entry.terminal:
            entry.status = EV_COMPLETE
            entry.text = rec.get("text", "")
            entry.gen_tokens = int(rec.get("gen", 0))
    elif ev == EV_FAILED:
        entry = entries.get(rid)
        if entry is not None and not entry.terminal:
            entry.status = EV_FAILED
            entry.reason = str(rec.get("reason", "error"))
            entry.detail = str(rec.get("detail", ""))
    elif ev == EV_CANCELLED:
        entry = entries.get(rid)
        if entry is not None and not entry.terminal:
            entry.status = EV_CANCELLED
            entry.reason = str(rec.get("reason", "api"))
    return False


# -- read-only inspection CLI -------------------------------------------------


def _main(argv: list[str] | None = None) -> int:
    """``python -m vnsum_tpu_torch.serve.journal <dir>``: dump a journal
    directory's ledger as JSON without opening it for writing — live /
    terminal counts plus every unfinished ACCEPT with its full replayable
    payload. The unfinished list is exactly what the router's
    journal-handoff failover re-dispatches onto survivors, so this is the
    handoff-debugging tool: point it at a dead worker's journal and see
    what is owed."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m vnsum_tpu_torch.serve.journal",
        description="Read-only request-journal inspection (no writes, "
                    "no compaction).",
    )
    parser.add_argument("directory", help="journal directory to read")
    args = parser.parse_args(argv)
    directory = Path(args.directory)
    if not directory.is_dir():
        print(json.dumps({"error": f"not a directory: {directory}"}),
              file=sys.stderr)
        return 2
    entries, sealed, torn = RequestJournal.read_state(directory)
    by_status: dict[str, int] = {}
    unfinished = []
    for entry in entries.values():
        by_status[entry.status] = by_status.get(entry.status, 0) + 1
        if not entry.terminal:
            unfinished.append({"rid": entry.rid, "status": entry.status,
                               "payload": entry.payload})
    out = {
        "directory": str(directory),
        "sealed": sealed,
        "torn_records": torn,
        "entries": len(entries),
        "live": len(unfinished),
        "terminal": len(entries) - len(unfinished),
        "by_status": by_status,
        "unfinished_accepts": unfinished,
    }
    print(json.dumps(out, ensure_ascii=False, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
