"""Flight recorder: a cheap bounded ring of typed lifecycle events, dumped
on anomalies.

The journal (serve/journal.py) answers "what happened to request X" and the
trace ring (obs/trace.py) answers "where did request X's time go" — but
neither answers the post-mortem question "what was the SERVER doing in the
seconds before it browned out / quarantined / breached its SLO". This is
that black box: every scheduler lifecycle transition (admit / dispatch /
complete / failed / shed / cancel / preempt / requeue / rung change /
journal replay / SLO breach) appends one tuple-cheap event to a bounded
deque, and anomaly triggers snapshot the whole ring to disk through the
existing crash-safe `core/artifacts.atomic_write_json` writer.

Dump triggers (wired in serve/scheduler.py, serve/server.py, serve/slo.py):
brownout entry, fatal engine failure, poison quarantine, sustained SLO
fast-burn, and SIGTERM drain. Dumps are throttled per reason
(``min_dump_interval_s``) so a quarantine storm produces one recording, not
a disk full of near-identical ones; with no ``directory`` configured the
ring still records and serves ``GET /debug/flightrecorder``, and dump()
returns None.

Cost when armed: one lock + deque.append per event — events fire per
REQUEST lifecycle transition (never per token or per scrape), the same
budget class as the metrics counters. A scheduler built with
``recorder=None`` pays only ``is None`` checks (the bench A/B's all-off
arm). Thread-safe: admit events fire under the queue lock, cancels from
HTTP handler threads, everything else from the scheduler thread — the
recorder lock is innermost like the journal's and takes no other lock
while held.

Copy of ``vnsum_tpu/obs/recorder.py``; only the imports and the names of the
device and its engine differ.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from pathlib import Path

from ..analysis.sanitizers import make_lock
from ..core.artifacts import atomic_write_json
from ..core.logging import get_logger

logger = get_logger("vnsum.obs.recorder")

# typed event kinds — one vocabulary shared with the journal where the two
# overlap (EV_* in serve/journal.py), so a dump's event sequence can be
# checked against the ledger's record for the same rid
EVENT_KINDS = (
    "admit", "dispatch", "complete", "failed", "shed", "cancel",
    "preempt", "requeue", "fault", "bisect", "rung_change",
    "journal_replay", "slo_breach", "stream",
    # watchdog liveness verdicts (serve/watchdog.py): a thread/dispatch
    # declared stalled, and a wedged-dispatch recovery that answered it
    "stall", "watchdog_recover",
    # fleet-router routing decisions (serve/router.py keeps its own ring —
    # the routing half of every incident bundle): a dispatch routed to a
    # worker, mark-down/mark-up transitions, a journal-handoff failover,
    # a worker process restart, and a minted incident id
    "route", "markdown", "markup", "failover", "handoff_replay",
    "worker_restart", "incident",
)

_dump_ids = itertools.count(1)


class FlightRecorder:
    """Bounded ring of typed lifecycle events + anomaly-triggered dumps."""

    def __init__(self, capacity: int = 4096,
                 directory: str | Path | None = None,
                 min_dump_interval_s: float = 5.0) -> None:
        self.capacity = max(int(capacity), 16)
        self.directory = Path(directory) if directory else None
        self.min_dump_interval_s = float(min_dump_interval_s)
        # lock-order-sanitizer hook: plain threading.Lock in production.
        # Innermost by contract — record() runs under the queue lock (the
        # admission hook) and must never acquire another serve lock
        self._lock = make_lock("obs.recorder")
        self._events: deque = deque(maxlen=self.capacity)  # guarded by: _lock
        self._dropped = 0                                  # guarded by: _lock
        self._seq = 0                                      # guarded by: _lock
        self._last_dump: dict[str, float] = {}             # guarded by: _lock
        self.dumps_written = 0  # monotone; racy scrape reads are fine
        self._t0 = time.monotonic()
        self._wall0 = time.time()

    # -- recording --------------------------------------------------------

    def record(self, kind: str, rid: str = "", **fields) -> None:
        """Append one typed event. ``rid`` is the request's trace_id ("" for
        server-level events like rung changes); extra fields must be
        JSON-serializable scalars/lists (the dump writer will not coerce)."""
        t = time.monotonic()
        with self._lock:
            self._seq += 1
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append((self._seq, t, kind, rid, fields or None))

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ring as a JSON-shaped dict — `GET /debug/flightrecorder` and
        every dump share this one serialization. Event timestamps are
        seconds since server start (t_rel) plus the wall-clock epoch of the
        start, so post-mortems can line events up with external logs."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            total = self._seq
        return {
            "started_wall": self._wall0,
            "capacity": self.capacity,
            "events_recorded": total,
            "events_dropped": dropped,
            "events": [
                {
                    "seq": seq,
                    "t_rel": round(t - self._t0, 6),
                    "kind": kind,
                    **({"rid": rid} if rid else {}),
                    **(fields or {}),
                }
                for seq, t, kind, rid, fields in events
            ],
        }

    def dump(self, reason: str) -> Path | None:
        """Snapshot the ring to ``flight_<reason>_<utc-ms>_<n>.json`` in the
        configured directory (atomic write). Throttled per reason; no-op
        (returns None) when no directory is configured or the reason dumped
        within ``min_dump_interval_s``."""
        if self.directory is None:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.min_dump_interval_s:
                return None
            self._last_dump[reason] = now
        payload = {
            "reason": reason,
            "dumped_wall": time.time(),
            **self.snapshot(),
        }
        # wall-clock ms in the name: dumps from successive PROCESSES on one
        # directory (chaos-soak restarts) must never overwrite each other
        path = self.directory / (
            f"flight_{reason}_{int(time.time() * 1000)}"
            f"_{next(_dump_ids):03d}.json"
        )
        try:
            atomic_write_json(path, payload)
        except OSError:
            # a full/unwritable disk must not turn an anomaly dump into a
            # second failure inside the scheduler's failure handling or a
            # SIGTERM drain — the ring stays intact for /debug/flightrecorder
            # (the throttle stamp stands: no point retrying for 5s)
            logger.exception("flight recorder dump to %s failed", path)
            return None
        with self._lock:
            # read-modify-write: breach dumps (daemon thread) race
            # scheduler-thread dumps
            self.dumps_written += 1
        logger.warning("flight recorder dumped %d event(s) to %s (%s)",
                       len(payload["events"]), path, reason)
        return path

    def stats_dict(self) -> dict:
        """Scrape-time counters for /metrics (vnsum_serve_recorder_*)."""
        with self._lock:
            return {
                "events": self._seq,
                "dropped": self._dropped,
                "dumps": self.dumps_written,
            }
