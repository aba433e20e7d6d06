"""Request/batch span model with cross-thread context propagation.

The serving path hands a request across three threads — the HTTP handler
(`serve/server.py`), the scheduler thread (`serve/scheduler.py`), and back —
and the engine (`backend/engine.py`) runs entirely inside the scheduler
thread. Two propagation mechanisms cover both seams, and both are explicit
about cost when tracing is off:

- **explicit carriage** for the queue handoff: a :class:`RequestTrace` rides
  the `ServeRequest` object itself (`serve/queue.py`), so whichever thread
  dequeues the request can attach spans to it — no thread-local can survive
  that handoff, so none is used;
- **a contextvar collector** for the engine: the scheduler sets the current
  :class:`BatchTrace` around `backend.generate` (:func:`set_collector`), and
  engine code calls the module-level :func:`emit` which no-ops on a single
  contextvar read when no collector is installed. The engine therefore needs
  no knowledge of the serving layer, and pipeline runs can install their own
  collector the same way.

Everything here is stdlib-only (no OpenTelemetry), allocation-free when
disabled (:func:`emit` allocates nothing without a collector; `ObsHub` with
`sample=0` never constructs a RequestTrace), and bounded: finished traces
land in fixed-size rings, never an unbounded list.

Timestamps are `time.monotonic()` seconds throughout; `obs/export.py`
rebases them to microseconds for Chrome trace-event JSON.

Copy of ``vnsum_tpu/obs/trace.py``; only the imports and the names of the
device and its engine differ.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from dataclasses import dataclass, field

from ..analysis.sanitizers import make_lock


@dataclass
class Span:
    """One closed wall-clock interval on a named track."""

    name: str
    t0: float          # time.monotonic() at entry
    dur: float         # seconds
    track: int = 0     # sub-track within the owning trace (0 = request level)
    args: dict | None = None


class SpanRecorder:
    """Thread-safe span sink with hierarchical naming.

    The shared span primitive under both `core/profiling.Tracer` (pipeline
    runs) and :class:`RequestTrace` (serving): nested ``span()`` blocks get
    `parent/child` names via a per-thread stack, closed spans append to a
    bounded list, and an optional ``on_close(full_name, duration)`` callback
    lets owners aggregate (the Tracer's SpanStats) without a second pass.
    """

    def __init__(self, maxlen: int = 4096, on_close=None) -> None:
        self.maxlen = maxlen
        self.on_close = on_close
        self._spans: list[Span] = []            # guarded by: _lock
        # lock-order-sanitizer hook: plain threading.Lock in production
        self._lock = make_lock("obs.spans")
        self._local = threading.local()

    def _stack(self) -> list[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, track: int = 0, **args):
        stack = self._stack()
        full = "/".join([*stack, name])
        stack.append(name)
        t0 = time.monotonic()
        try:
            yield
        finally:
            dur = time.monotonic() - t0
            stack.pop()
            self.add(full, t0, dur, track=track, **args)
            if self.on_close is not None:
                self.on_close(full, dur)

    def add(self, name: str, t0: float, dur: float, track: int = 0, **args) -> None:
        """Record an externally-timed span (no nesting bookkeeping)."""
        sp = Span(name, t0, dur, track, args or None)
        with self._lock:
            if len(self._spans) < self.maxlen:
                self._spans.append(sp)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


class RequestTrace:
    """Spans of ONE request, across every thread and queue trip it takes.

    Created at the entry point (HTTP handler or scheduler submit), carried by
    reference on each `ServeRequest` the request fans out into (a summarize
    request's strategy rounds all share one trace), appended to from the
    scheduler thread, and finalized back at the entry point. ``track`` 0 is
    the request level; each fanned-out prompt claims its own sub-track via
    :meth:`next_track` so overlapping per-prompt intervals stay on separate
    Perfetto tracks instead of producing an improperly-nested slice stack.
    """

    # instances constructed since import — the overhead-guard test asserts
    # this does not move during an untraced serving run
    allocations = 0

    __slots__ = ("trace_id", "t_start", "status", "spans", "_lock",
                 "_tracks", "parent")

    def __init__(self, trace_id: str, parent: str | None = None) -> None:
        RequestTrace.allocations += 1
        self.trace_id = trace_id
        # cross-process trace context: the span name of the upstream hop
        # that dispatched this request (the fleet router's proxy span rides
        # in on an X-Parent-Span header). The merged fleet trace uses it to
        # nest worker timelines under the router's root span
        self.parent = parent
        self.t_start = time.monotonic()
        self.status = "open"                    # guarded by: _lock
        self.spans: list[Span] = []             # guarded by: _lock
        # lock-order-sanitizer hook: plain threading.Lock in production
        self._lock = make_lock("obs.trace")
        self._tracks = 0                        # guarded by: _lock

    def next_track(self) -> int:
        with self._lock:
            self._tracks += 1
            return self._tracks

    def add(self, name: str, t0: float, dur: float, track: int = 0, **args) -> None:
        with self._lock:
            # a finished trace is immutable: it may already sit in the
            # export ring. Late spans happen legitimately — a shed aborts
            # the request mid-fan-out while admitted sibling prompts are
            # still queued; their eventual completions must not mutate the
            # closed (possibly being-exported) timeline
            if self.status != "open":
                return
            self.spans.append(Span(name, t0, dur, track, args or None))

    @contextlib.contextmanager
    def span(self, name: str, track: int = 0, **args):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(name, t0, time.monotonic() - t0, track, **args)

    def finish(self, status: str = "ok") -> None:
        """Close the request-level span (track 0, full residency) and seal
        the trace against further mutation."""
        self.add("request", self.t_start, time.monotonic() - self.t_start,
                 track=0, status=status)
        with self._lock:
            self.status = status

    def spans_snapshot(self) -> list[Span]:
        """Consistent copy for exporters — finished traces are immutable,
        but a shed trace can be exported while a straggler add() races the
        seal, so exporters never iterate the live list."""
        with self._lock:
            return list(self.spans)


class BatchTrace:
    """Telemetry of ONE engine batch: occupancy plus the step events the
    backend emitted while it was the installed collector.

    The engine's phase events (prefill / decode segments / spec steps) are
    host timestamps around already-dispatched device calls — recording them
    adds no device synchronization the hot path wasn't already paying
    (`backend/engine.py` fetches `done` masks per segment regardless).
    ``first_token_at`` is the host-observed end of the prefill phase, the
    anchor `serve/scheduler.py` derives per-request TTFT from.
    """

    __slots__ = ("batch_id", "t0", "t1", "occupancy", "events",
                 "first_token_at", "gen_tokens")

    def __init__(self, batch_id: int, occupancy: int) -> None:
        self.batch_id = batch_id
        self.t0 = time.monotonic()
        self.t1: float | None = None
        self.occupancy = occupancy
        self.events: list[Span] = []
        self.first_token_at: float | None = None
        self.gen_tokens = 0

    def event(self, name: str, t0: float, dur: float, **args) -> None:
        # single-threaded by the serving contract (one scheduler thread owns
        # the engine), so no lock — list.append is atomic enough for the
        # read-after-generate consumer either way
        self.events.append(Span(name, t0, dur, 0, args or None))
        # TTFT anchor: only a SYNC-BOUNDED prefill end qualifies. Backends
        # whose prefill call returns at async dispatch mark the event
        # synced=False (the JAX engine without instrument=True) — anchoring on
        # that would record near-zero prefill and poison the TTFT quantiles
        # with queue-wait-only values. Absent flag = synchronous backend
        # (FakeBackend's sleep, instrumented engine fetches).
        if (
            self.first_token_at is None
            and name in ("prefill", "spec_prefill")
            and args.get("synced", True)
        ):
            self.first_token_at = t0 + dur

    def close(self, gen_tokens: int = 0) -> None:
        self.t1 = time.monotonic()
        self.gen_tokens = gen_tokens


# -- engine-side collector propagation ---------------------------------------

_collector: contextvars.ContextVar[BatchTrace | None] = contextvars.ContextVar(
    "vnsum_obs_collector", default=None
)


def set_collector(c: BatchTrace | None):
    """Install ``c`` as the current emit() target; returns a token for
    :func:`reset_collector`. The scheduler wraps each backend.generate call;
    pipeline/bench code may install a collector the same way."""
    return _collector.set(c)


def reset_collector(token) -> None:
    _collector.reset(token)


def current_collector() -> BatchTrace | None:
    return _collector.get()


def emit(name: str, t0: float, dur: float, **args) -> None:
    """Record an engine phase event onto the current collector, if any.

    THE hot-path guard: one contextvar read and a None check when tracing is
    off — no allocation, no lock, no timestamp math (callers only compute
    timestamps they already had or guard them behind :func:`current_collector`).
    """
    c = _collector.get()
    if c is not None:
        c.event(name, t0, dur, **args)


# -- hub: sampling + bounded retention ---------------------------------------


class ObsHub:
    """Owns sampling policy and the bounded rings of finished traces.

    One hub per serving process (`serve/server.py` builds it from
    ``--trace-sample`` / ``--trace-ring``). ``sample`` is the fraction of
    requests traced, applied with a deterministic error-diffusion accumulator
    (exactly ``sample`` of requests long-run, no RNG); batches are recorded
    whenever the hub exists — they are few and carry the engine telemetry.
    A hub is never constructed when tracing is disabled, so the disabled
    path's only cost is `is None` checks.
    """

    def __init__(self, sample: float = 1.0, ring: int = 256) -> None:
        self.sample = max(0.0, min(float(sample), 1.0))
        self.ring = max(int(ring), 1)
        # lock-order-sanitizer hook: plain threading.Lock in production
        self._lock = make_lock("obs.hub")
        # error-diffusion start point: the FIRST request is always sampled
        # (the next += sample crosses 1.0 immediately) and the long-run
        # traced fraction is exactly `sample`
        self._acc = 1.0 - self.sample           # guarded by: _lock
        self._requests: list[RequestTrace] = []  # guarded by: _lock
        self._batches: list[BatchTrace] = []    # guarded by: _lock
        self._batch_seq = 0                     # guarded by: _lock
        self.dropped_requests = 0               # guarded by: _lock

    # -- request side ----------------------------------------------------

    def start_request(self, trace_id: str,
                      parent: str | None = None) -> RequestTrace | None:
        """A RequestTrace when this request is sampled, else None.
        ``parent`` carries cross-process trace context (the router's
        X-Parent-Span header) onto the trace."""
        if self.sample <= 0.0:
            return None
        with self._lock:
            self._acc += self.sample
            if self._acc < 1.0:
                return None
            self._acc -= 1.0
        return RequestTrace(trace_id, parent=parent)

    def finish_request(self, trace: RequestTrace | None,
                       status: str = "ok") -> None:
        if trace is None:
            return
        trace.finish(status)
        with self._lock:
            self._requests.append(trace)
            if len(self._requests) > self.ring:
                del self._requests[0]
                self.dropped_requests += 1

    # -- batch side ------------------------------------------------------

    def start_batch(self, occupancy: int) -> BatchTrace:
        with self._lock:
            self._batch_seq += 1
            return BatchTrace(self._batch_seq, occupancy)

    def finish_batch(self, bt: BatchTrace, gen_tokens: int = 0) -> None:
        bt.close(gen_tokens)
        with self._lock:
            self._batches.append(bt)
            if len(self._batches) > self.ring:
                del self._batches[0]

    # -- export ----------------------------------------------------------

    def snapshot(self) -> tuple[list[RequestTrace], list[BatchTrace]]:
        with self._lock:
            return list(self._requests), list(self._batches)

    def chrome_trace(self) -> dict:
        from .export import chrome_trace

        reqs, batches = self.snapshot()
        return chrome_trace(reqs, batches)
