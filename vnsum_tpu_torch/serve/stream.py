"""Per-request streaming emit channel: scheduler harvest -> HTTP response.

The in-flight slot loop already surfaces every segment boundary to the host
(serve/inflight.py::_run_segment) — streaming is "only" the plumbing from
that boundary to the client socket. A :class:`StreamChannel` is that pipe:
the SCHEDULER thread pushes text snapshots as a request's decode advances
(and the harvest's final text at completion), the HTTP handler thread pops
delta events and writes them as SSE frames. The channel never blocks the
scheduler: pushes never wait, and a slow/disconnected client only grows its
own channel up to ``maxsize`` — past that, pending same-kind events are
COALESCED (deltas concatenate, progress keeps the latest), so a wedged
consumer costs one bounded buffer, never unbounded memory.

Delta discipline — what makes ``"".join(deltas) == final_text`` a hard
invariant rather than a hope:

- ``push_text`` takes the FULL decoded text so far and emits only the
  suffix beyond what was already emitted;
- a snapshot that does not extend the emitted prefix (preemption restarted
  the request from scratch; a tokenizer boundary re-rendered a partial
  piece) emits NOTHING — emission resumes once decode re-passes the
  high-water mark, and the completion push flushes whatever remains;
- the completion's text goes through the same path, so the concatenation
  identity holds for every request, including preempted-and-requeued ones;
- coalescing concatenates ADJACENT pending deltas in order, which is the
  identity's own operation — a coalesced stream reassembles byte-identically.

Resume (serve/server.py ``Last-Event-ID``): every event carries a monotone
``seq``; ``emitted_text`` snapshots the producer high-water mark, so a
reconnecting client gets one full-text ``snapshot`` event and then live
deltas. ``attach()`` hands the channel to the NEW consumer — a previous
handler still blocked on ``pop`` gets :class:`StreamDetached` and exits
without writing a terminal frame. ``last_consumed`` (refreshed by every pop
and attach) is the idle-consumer clock the scheduler's disconnect sweep
cancels on.

The channel carries no terminal sentinel: the HTTP layer already holds the
request future (or the summarize worker thread) and drains the channel
after it resolves — resolution ordering in the scheduler (deltas pushed
BEFORE the future) makes that race-free.

Copy of ``vnsum_tpu/serve/stream.py``; only the imports and the names of the
device and its engine differ.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..analysis.sanitizers import make_lock


class StreamDetached(RuntimeError):
    """Raised out of ``pop`` to a consumer whose attachment was superseded
    (a reconnecting client called ``attach``) — the stale handler must stop
    draining and exit WITHOUT writing a terminal event."""


class StreamChannel:
    """One request's emit channel. Producer: the scheduler thread (pushes
    are in dispatch/harvest order). Consumer: the HTTP handler thread — at
    most ONE live consumer at a time (``attach`` supersedes)."""

    def __init__(self, request_id: str = "", maxsize: int = 256,
                 metrics=None) -> None:
        self.request_id = request_id
        self.maxsize = max(int(maxsize), 2)
        # backpressure-coalesce observer (ServeMetrics) — the channel calls
        # observe_stream_coalesced under its own lock; the metrics lock is
        # a leaf in the lock-order graph, so stream -> metrics is safe
        self.metrics = metrics
        # lock-order-sanitizer hook: plain threading.Lock in production
        # _cond wraps _lock (one underlying mutex, two names); the
        # guarded-by annotations list both so either entry form satisfies
        # the lint — same convention as serve/queue.py
        self._lock = make_lock("serve.stream")
        self._cond = threading.Condition(self._lock)
        self._q: deque = deque()      # guarded by: _cond, _lock
        self._seq = 0                 # guarded by: _cond, _lock
        self._sent = ""               # guarded by: _cond, _lock
        self._closed = False          # guarded by: _cond, _lock
        self._gen = 0                 # guarded by: _cond, _lock
        self.events_pushed = 0
        self.coalesced = 0
        # idle-consumer clock: refreshed by every pop/attach; read lock-free
        # by the scheduler's disconnect sweep (a stale float read only
        # delays one sweep iteration, never corrupts)
        self.last_consumed = time.monotonic()

    # -- producer side (scheduler thread) ---------------------------------

    def _append_locked(self, kind: str, payload: dict) -> None:
        if self._closed:
            return  # dead stream: the consumer is gone for good, drop
        self._seq += 1
        self._q.append((kind, payload, self._seq))
        self.events_pushed += 1
        if len(self._q) >= self.maxsize:
            self._coalesce_locked()
        self._cond.notify_all()

    def _coalesce_locked(self) -> None:
        """Collapse pending same-kind runs: adjacent deltas concatenate into
        one (the concatenation identity's own operation, so reassembly is
        unaffected); for other kinds (progress) only the LATEST of a run
        survives — their payloads are monotone snapshots. Each merged event
        keeps the run's newest seq, so resume ids stay monotone.

        If adjacent merging alone cannot get back under the bound (a
        pathological alternation like delta/progress/delta/...), collapse
        GLOBALLY: one delta event carrying every pending delta in order
        (identity still intact) plus the latest event of each other kind —
        the queue then holds at most one event per kind, a hard bound, so
        a wedged consumer can never make this pass quadratic either."""
        merged: deque = deque()
        dropped = 0
        for kind, payload, seq in self._q:
            if merged and merged[-1][0] == kind:
                last_kind, last_payload, _last_seq = merged[-1]
                if kind == "delta":
                    payload = {
                        **payload,
                        "text": last_payload["text"] + payload["text"],
                    }
                merged[-1] = (kind, payload, seq)
                dropped += 1
            else:
                merged.append((kind, payload, seq))
        if len(merged) >= self.maxsize:
            slots: dict[str, int] = {}  # kind -> index in the output
            flat: list = []
            for kind, payload, seq in merged:
                at = slots.get(kind)
                if at is None:
                    slots[kind] = len(flat)
                    flat.append((kind, dict(payload), seq))
                else:
                    prev = flat[at][1]
                    if kind == "delta":
                        payload = {**payload,
                                   "text": prev["text"] + payload["text"]}
                    flat[at] = (kind, dict(payload), seq)
                    dropped += 1
            merged = deque(flat)
        self._q = merged
        if dropped:
            self.coalesced += dropped
            if self.metrics is not None:
                self.metrics.observe_stream_coalesced(dropped)

    def push_text(self, text_so_far: str) -> bool:
        """Emit the suffix of ``text_so_far`` beyond what was already
        emitted; returns True when a delta actually left. Non-extending
        snapshots (preemption restart, re-rendered partial detok) emit
        nothing — see the module docstring's delta discipline."""
        with self._cond:
            if (
                not text_so_far
                or not text_so_far.startswith(self._sent)
                or len(text_so_far) <= len(self._sent)
            ):
                return False
            delta = text_so_far[len(self._sent):]
            self._sent = text_so_far
            self._append_locked("delta", {"text": delta})
            return True

    def push_event(self, kind: str, payload: dict) -> None:
        """Out-of-band event (summarize round progress etc.)."""
        with self._cond:
            self._append_locked(kind, dict(payload))

    # -- consumer side (HTTP handler thread) ------------------------------

    def pop(self, timeout_s: float,
            gen: int | None = None) -> tuple[str, dict, int] | None:
        """Next (kind, payload, seq), or None on an empty poll — the caller
        re-checks the request future and keeps draining. ``gen`` is the
        attachment token from :meth:`attach`; a superseded consumer gets
        :class:`StreamDetached` instead of stealing the new one's events."""
        self.last_consumed = time.monotonic()
        t_end = time.monotonic() + timeout_s
        with self._cond:
            while True:
                if gen is not None and gen != self._gen:
                    raise StreamDetached(self.request_id)
                if self._q:
                    return self._q.popleft()
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(timeout=remaining)

    def resume_snapshot(self) -> tuple[str, int]:
        """Atomically (text, seq) for a ``Last-Event-ID`` reconnect: the
        full emitted text so far, with buffered DELTA events dropped —
        their text is already inside the snapshot (push_text advances the
        high-water mark at push, not at pop), so replaying them after the
        snapshot would double bytes. Non-delta events (summarize progress)
        stay queued. Deltas pushed after this call are suffixes beyond the
        snapshot, so snapshot + subsequent deltas == final text — the
        resumed form of the concatenation identity."""
        with self._cond:
            self._q = deque(e for e in self._q if e[0] != "delta")
            return self._sent, self._seq

    def attach(self) -> int:
        """Claim the channel for a (re)connecting consumer; any previous
        consumer's pops raise StreamDetached from now on. Refreshes the
        idle clock, so a resume-in-time beats the disconnect sweep."""
        self.last_consumed = time.monotonic()
        with self._cond:
            self._gen += 1
            self._cond.notify_all()
            return self._gen

    def empty(self) -> bool:
        with self._lock:
            return not self._q

    @property
    def emitted_text(self) -> str:
        """The producer high-water mark — everything already emitted as
        deltas. A resume replays this as one ``snapshot`` event and then
        continues with live deltas (snapshot + subsequent deltas == the
        final text, the resumed form of the concatenation identity)."""
        with self._lock:
            return self._sent

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def idle_for(self) -> float:
        """Seconds since a consumer last popped (or attached) — the
        disconnect sweep's signal. Lock-free read by design."""
        return time.monotonic() - self.last_consumed

    def close(self) -> None:
        """Drop buffered events and make further pushes no-ops: called when
        the request is terminally resolved with no consumer left (cancel,
        disconnect past the resume window) so a dead stream costs nothing."""
        with self._cond:
            self._closed = True
            self._q.clear()
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed


class StreamRegistry:
    """Live streams by request id — the ``Last-Event-ID`` resume surface
    (serve/server.py). An entry outlives its HTTP handler on purpose: a
    disconnected client reconnects within the idle window and reattaches.
    Size is bounded two ways: terminal-and-drained entries are pruned on
    every register, and an LRU cap evicts the oldest beyond ``max_entries``
    (an evicted stream simply loses resumability, never correctness — the
    request itself is owned by the scheduler)."""

    def __init__(self, max_entries: int = 256) -> None:
        self.max_entries = max(int(max_entries), 1)
        # lock-order-sanitizer hook: HTTP handler threads only; never held
        # while taking any other serve lock except stream (attach/close)
        self._lock = make_lock("serve.streams")
        self._entries: dict[str, tuple] = {}  # rid -> (channel, future)

    def register(self, rid: str, channel: StreamChannel, future) -> None:
        with self._lock:
            self._prune_locked()
            self._entries[rid] = (channel, future)
            while len(self._entries) > self.max_entries:
                old_rid = next(iter(self._entries))
                self._entries.pop(old_rid)

    def _prune_locked(self) -> None:
        done = [
            rid for rid, (ch, fut) in self._entries.items()
            if fut.done() and (ch.closed or ch.empty())
        ]
        for rid in done:
            self._entries.pop(rid, None)

    def get(self, rid: str) -> tuple | None:
        with self._lock:
            return self._entries.get(rid)

    def unregister(self, rid: str) -> None:
        with self._lock:
            self._entries.pop(rid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
