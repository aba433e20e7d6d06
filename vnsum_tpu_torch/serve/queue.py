"""Bounded request queue with deadline-aware admission control.

Admission is decided at submit time against two budgets — queue depth and
total queued prompt tokens — and rejection is a TYPED result (RequestShed
with a ShedReason), not a dropped connection: the HTTP layer maps it to a
429-style response, the QueuedBackend adapter re-raises it into the calling
strategy, and the metrics layer counts it per reason. Requests carry an
absolute monotonic deadline; expired requests are shed at dispatch time so a
backed-up queue never spends engine capacity on answers nobody is waiting
for (BASS, arXiv:2404.15778 frames both as the load-shedding half of
continuous batching).

The queue itself is deliberately dumb: ordering is FIFO, and all batching
policy (compatibility keys, max-wait/max-batch) lives in take_batch's
caller-supplied parameters so the scheduler owns the policy and the queue
owns the synchronization.

Copy of ``vnsum_tpu/serve/queue.py``; only the imports and the names of the
device and its engine differ.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from enum import Enum

from ..analysis.sanitizers import make_lock
from ..core.config import GenerationConfig


class ShedReason(str, Enum):
    QUEUE_FULL = "queue_full"
    TOKEN_BUDGET = "token_budget"
    DEADLINE = "deadline"
    SHUTDOWN = "shutdown"
    # graceful-degradation ladder bottom rung (serve/supervisor.py): the
    # supervisor browned the server out after repeated resource-class
    # failures — mapped to HTTP 503 + Retry-After, not 429
    BROWNOUT = "brownout"


class RequestShed(RuntimeError):
    """Typed 429/503-style rejection: admission control, deadline shedding,
    or supervisor brownout.

    Raised synchronously by submit() (admission) or delivered through the
    request future (deadline/shutdown shedding after the request was
    admitted). ``retry_after_s`` is the client backoff hint for brownout
    sheds (the HTTP layer renders it as a Retry-After header)."""

    def __init__(self, reason: ShedReason, detail: str = "",
                 retry_after_s: float | None = None) -> None:
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(
            f"request shed ({reason.value})" + (f": {detail}" if detail else "")
        )


class RequestCancelled(RuntimeError):
    """Typed terminal cancellation: the client asked for it
    (``DELETE /v1/requests/<id>``) or stopped listening (stream disconnect
    past the resume window / idle-consumer timeout). Delivered through the
    request future; the HTTP layer maps it to a 409 and the streaming
    layer to a typed terminal ``error`` event. ``stage`` names where in
    the lifecycle the cancel landed (queued / dispatched / resident) and
    ``reason`` why (api / disconnect)."""

    def __init__(self, stage: str = "", reason: str = "api") -> None:
        self.stage = stage
        self.reason = reason
        super().__init__(
            f"request cancelled ({reason})"
            + (f" while {stage}" if stage else "")
        )


_ids = itertools.count()


@dataclass
class ServeRequest:
    """One prompt awaiting a shared engine batch."""

    prompt: str
    max_new_tokens: int | None = None
    config: GenerationConfig | None = None
    # source text for reference-guided speculative decoding (vnsum_tpu_torch.spec);
    # per-ROW metadata, so it never enters batch_key — requests with
    # different references still coalesce
    reference: str | None = None
    # prefix-cache hint (vnsum_tpu_torch.cache): the prompt prefix the caller
    # expects to recur. Per-ROW metadata like reference — never part of
    # batch_key — but take_batch uses it to CLUSTER compatible requests so
    # shared-prefix rows land in the same engine batch (the engine's usable
    # skip is bounded by the batch's coldest row)
    cache_hint: str | None = None
    # tokens of this prompt the backend's prefix cache already holds
    # (cached_prefix_tokens probe at submit); admission control bills only
    # the difference — a cached 10k-token header shouldn't crowd out work
    # the engine will never actually prefill
    cached_tokens: int = 0
    # absolute time.monotonic() deadline; None = no deadline
    deadline: float | None = None
    est_tokens: int = 0
    request_id: int = field(default_factory=lambda: next(_ids))
    # end-to-end correlation id (vnsum_tpu_torch.obs): defaults to a queue-derived
    # id in __post_init__; the HTTP layer overrides it with the client's
    # X-Request-Id so one id links response header, logs, and /debug/trace.
    # Fanned-out prompts of one request share a trace_id but keep their own
    # request_id — per-ROW metadata, never part of batch_key
    trace_id: str = ""
    # the shared RequestTrace this row's spans land on (None = untraced) and
    # this row's sub-track within it; set by the scheduler at submit
    trace: object | None = field(default=None, repr=False, compare=False)
    trace_track: int = 0
    # scheduler-owned trace lifecycle: True when the scheduler created the
    # trace at submit (no HTTP layer to finalize it) and must finish it on
    # completion
    own_trace: bool = False
    # supervised-retry bookkeeping (serve/supervisor.py): how many FAILED
    # engine dispatches this request has been part of; the supervisor's
    # per-request retry budget caps it
    attempts: int = 0
    # structured jobs (serve/gang.py): the gang this row belongs to ("" =
    # ungrouped). Fan-out siblings of one summarize/skeleton request share
    # it; the queue's take paths cluster same-gang rows into one slot
    # generation (so they share the template-header prefix in the radix
    # cache). Per-ROW metadata, never part of batch_key
    gang_id: str = ""
    # streaming (serve/stream.py): the per-request emit channel the
    # scheduler pushes decode-progress text into (None = non-streaming).
    # Never compared/printed — it carries a live Queue
    stream: object | None = field(default=None, repr=False, compare=False)
    # watchdog recovery (serve/inflight.py): how many times this request
    # was evicted mid-decode and requeued, and the prefix-cache pins taken
    # at eviction so its cached blocks survive LRU until it terminally
    # resolves — released by the scheduler's resolution paths
    preemptions: int = 0
    preempt_pins: list = field(default_factory=list, repr=False,
                               compare=False)
    enqueued_at: float = field(default_factory=time.monotonic)
    future: Future = field(default_factory=Future)

    def __post_init__(self) -> None:
        if not self.trace_id:
            self.trace_id = f"req-{self.request_id}"

    @property
    def billable_tokens(self) -> int:
        """Prompt tokens the engine will actually prefill — what the
        admission token budget counts."""
        return max(self.est_tokens - self.cached_tokens, 0)

    def batch_key(self) -> tuple:
        """Requests sharing this key can ride one engine batch: the engine
        applies max_new_tokens and the GenerationConfig per CALL, not per
        row, so only same-parameter requests may coalesce. GenerationConfig
        is frozen/hashable by construction."""
        return (self.max_new_tokens, self.config)

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline


class RequestQueue:
    """FIFO queue with depth + token-budget admission and batch take-out.

    ``max_depth`` bounds queued requests; ``max_queued_tokens`` (0 =
    unlimited) bounds the sum of queued prompt-token estimates so a few
    book-length prompts can't squeeze out hundreds of short ones while
    nominally fitting the depth budget. The estimate is each request's
    BILLABLE tokens — prompt tokens minus its prefix-cache coverage — so
    cached template headers don't consume admission budget the engine will
    never spend prefilling."""

    def __init__(self, max_depth: int = 256, max_queued_tokens: int = 0) -> None:
        self.max_depth = max_depth
        self.max_queued_tokens = max_queued_tokens
        # _cond wraps _lock (one underlying mutex, two names); the
        # guarded-by annotations list both so either entry form satisfies
        # the lint. make_lock = lock-order-sanitizer hook (analysis pkg):
        # a plain threading.Lock unless VNSUM_SANITIZERS enables tracking
        self._lock = make_lock("serve.queue")
        self._cond = threading.Condition(self._lock)
        self._items: list[ServeRequest] = []    # guarded by: _cond, _lock
        self._queued_tokens = 0                 # guarded by: _cond, _lock
        self._closed = False                    # guarded by: _cond, _lock
        self.on_shed = None  # callable(req, ShedReason) | None — metrics hook
        # called under the queue lock BEFORE the scheduler can take the
        # request: counting the admit here means no scrape window where a
        # request is completed but not yet counted as submitted
        self.on_admit = None  # callable(req) | None — metrics hook
        # called under the queue lock with each taken batch (the commit
        # point) — the gang-affinity observability hook (serve/gang.py):
        # the scheduler counts multi-row takes that landed one gang
        # together. Must be cheap and lock-free like on_admit
        self.on_take = None  # callable(list[req]) | None — metrics hook
        # gang-affinity pick (serve/gang.py): when an over-full take must
        # choose, cluster the head's gang first so fan-out siblings ride
        # one slot generation and share their template-header prefix in
        # the radix cache. False = the pre-gang cache-hint clustering only
        # (the bench A/B's off arm)
        self.gang_affinity = True
        # supervisor brownout gate (serve/supervisor.py::admission_gate):
        # callable() -> Retry-After seconds when the degradation ladder is
        # shedding new work, None when admitting. Consulted for EXTERNAL
        # submissions only — internal fan-out of already-admitted requests
        # (force=True) must finish even under brownout
        self.degraded = None
        # watchdog liveness stamp (serve/watchdog.py): the scheduler wires
        # its Heartbeat.beat here so the take loops tick it on every
        # wake-up — an IDLE scheduler parked in a bounded cond-wait still
        # proves liveness. One attribute write per wake-up, called under
        # the queue lock (beat takes no lock of its own). None = unmonitored
        self.heartbeat = None

    # -- producer side ---------------------------------------------------

    def submit(self, req: ServeRequest, *, force: bool = False) -> Future:
        """Admit or shed. Sheds raise RequestShed SYNCHRONOUSLY (the caller
        never gets a future that was doomed at admission).

        ``force=True`` skips the depth/token-budget checks (not the
        shutdown/deadline ones): it is for the INTERNAL fan-out of work
        that was already admitted at the request level — e.g. a summarize
        request whose map round splits into more prompts than max_depth
        must not shed itself against an idle server. External entry points
        must never set it."""
        with self._cond:
            if self._closed:
                self._shed_locked(req, ShedReason.SHUTDOWN)
            if req.expired():
                # Retry-After 1: the client's own deadline passed — "retry
                # now with a fresh deadline", not a server back-off
                self._shed_locked(req, ShedReason.DEADLINE, retry_after_s=1.0)
            if not force:
                shed = self._admission_reason_locked(req.billable_tokens)
                if shed is not None:
                    self._shed_locked(req, shed[0], retry_after_s=shed[1])
            self._items.append(req)
            self._queued_tokens += req.billable_tokens
            if self.on_admit is not None:
                self.on_admit(req)
            self._cond.notify_all()
        return req.future

    def _admission_reason_locked(
        self, est_tokens: int
    ) -> tuple[ShedReason, float | None] | None:
        """The ONE depth/token-budget/brownout admission predicate —
        submit() and check_admission() must never diverge on policy.
        Returns (reason, retry_after_s) or None. The degraded gate is
        evaluated exactly ONCE per decision: it doubles as the supervisor's
        recovery probe, so a second call could observe a different (healed)
        ladder and desynchronize the shed from its Retry-After hint.

        Every 429-class reason carries a derived Retry-After: queue_full
        and token_budget scale with backlog (a deeper queue needs a longer
        back-off than a barely-full one)."""
        if self.degraded is not None:
            retry_after = self.degraded()
            if retry_after is not None:
                return ShedReason.BROWNOUT, retry_after
        if len(self._items) >= self.max_depth:
            return ShedReason.QUEUE_FULL, self._backlog_retry_after_locked()
        if (
            self.max_queued_tokens
            and self._items  # an empty queue always admits one request
            and self._queued_tokens + est_tokens > self.max_queued_tokens
        ):
            return ShedReason.TOKEN_BUDGET, self._backlog_retry_after_locked()
        return None

    def _backlog_retry_after_locked(self) -> float:
        """Retry-After for backlog sheds (queue_full / token_budget): the
        queue has no view of engine speed, so the hint scales with depth —
        ~50ms of assumed drain per queued request, clamped to [1, 30]s.
        Deliberately coarse: the point is a depth-proportional back-off
        signal, not a latency forecast."""
        return min(30.0, max(1.0, 0.05 * len(self._items)))

    def check_admission(self, est_tokens: int = 0) -> None:
        """Request-level admission probe without enqueueing: raises the same
        typed RequestShed a submit would. Entry points whose work fans out
        through force-submits (the summarize path) call this ONCE up front
        so admission control still applies per request."""
        with self._lock:
            if self._closed:
                raise RequestShed(ShedReason.SHUTDOWN)
            shed = self._admission_reason_locked(est_tokens)
            if shed is not None:
                raise RequestShed(shed[0], retry_after_s=shed[1])

    def _shed_locked(self, req: ServeRequest, reason: ShedReason,
                     retry_after_s: float | None = None):
        if self.on_shed is not None:
            self.on_shed(req, reason)
        exc = RequestShed(reason, retry_after_s=retry_after_s)
        # resolve the future too, for callers holding it (take-side sheds)
        if not req.future.done():
            req.future.set_exception(exc)
        raise exc

    # -- consumer side ---------------------------------------------------

    def _shed_expired_locked(self, now: float) -> None:
        live = []
        for r in self._items:
            if r.expired(now):
                self._queued_tokens -= r.billable_tokens
                if self.on_shed is not None:
                    self.on_shed(r, ShedReason.DEADLINE)
                if not r.future.done():
                    r.future.set_exception(
                        RequestShed(ShedReason.DEADLINE, retry_after_s=1.0)
                    )
            else:
                live.append(r)
        self._items = live

    def _compat_locked(self, key: tuple, max_take: int) -> list[ServeRequest]:
        """Requests sharing ``key`` — with prefix-cache clustering
        (vnsum_tpu_torch.cache) when more compatible requests wait than one take
        holds: fill with the head's cache_hint group first, because the
        engine's usable prefill skip is bounded by the batch's coldest row,
        so mixing hint groups wastes everyone's cached prefix. FIFO order
        is preserved within each part, and nothing reorders when the take
        drains everyone anyway. The ONE compatibility/clustering policy for
        take_batch and take_upto — the two paths must never diverge.

        Gang affinity (serve/gang.py) outranks cache-hint clustering when
        the head row belongs to a gang: siblings of one structured job
        share the SAME template-header hint by construction, so keeping
        the gang together is the strictly stronger form of the same
        cache argument. Ungrouped heads fall through to the pre-gang behavior byte for byte."""
        compat = [r for r in self._items if r.batch_key() == key]
        if len(compat) <= max_take:
            return compat
        if self.gang_affinity and compat[0].gang_id:
            gang = compat[0].gang_id
            compat = (
                [r for r in compat if r.gang_id == gang]
                + [r for r in compat if r.gang_id != gang]
            )
        elif any(r.cache_hint for r in compat):
            hint = compat[0].cache_hint
            compat = (
                [r for r in compat if r.cache_hint == hint]
                + [r for r in compat if r.cache_hint != hint]
            )
        return compat

    def _take_locked(self, compat: list[ServeRequest],
                     max_take: int) -> list[ServeRequest]:
        """Remove up to ``max_take`` of ``compat`` from the queue and
        release their token bill — the ONE removal/billing block shared by
        both take paths."""
        batch = compat[:max_take]
        taken = set(id(r) for r in batch)
        self._items = [r for r in self._items if id(r) not in taken]
        for r in batch:
            self._queued_tokens -= r.billable_tokens
        if self.on_take is not None and batch:
            self.on_take(batch)
        return batch

    def take_batch(self, max_batch: int, max_wait_s: float) -> list[ServeRequest] | None:
        """Block until a batch is ready, then return up to ``max_batch``
        requests sharing the head-of-line request's batch_key. A batch is
        ready when it is full, when the coalescing window ``max_wait_s`` has
        elapsed, or when the queue is closed (drain). Returns None when
        closed and empty — the scheduler's exit signal. Expired requests are
        shed on every wake-up.

        The window anchors on max(head arrival, THIS CALL's entry): under
        light load that is head arrival (a lone request waits at most
        max_wait_s), but after a long engine dispatch the backlog's head is
        already older than any window — anchoring on entry keeps a brief
        coalescing window open so requests unblocked by the *previous*
        batch's responses can join this one instead of fragmenting into
        near-empty dispatches (the JAX package's serving bench measured
        the occupancy this recovers)."""
        t_enter = time.monotonic()
        with self._cond:
            while True:
                if self.heartbeat is not None:
                    self.heartbeat()
                now = time.monotonic()
                self._shed_expired_locked(now)
                if not self._items:
                    if self._closed:
                        return None
                    self._cond.wait(timeout=0.1)
                    continue
                head = self._items[0]
                compat = self._compat_locked(head.batch_key(), max_batch)
                flush_at = max(head.enqueued_at, t_enter) + max_wait_s
                if len(compat) >= max_batch or now >= flush_at or self._closed:
                    return self._take_locked(compat, max_batch)
                self._cond.wait(timeout=max(flush_at - now, 0.001))

    def take_upto(
        self, max_take: int, key: tuple | None = None, wait_s: float = 0.0
    ) -> list[ServeRequest] | None:
        """Slot-feeding take for the in-flight scheduler: up to ``max_take``
        requests compatible with ``key`` (None = the head-of-line request's
        batch_key), FIFO within the key with the same cache-hint clustering
        as take_batch. Admission is billed per slot: each request's billable
        tokens leave the queue budget when its slot is taken, not when a
        whole batch flushes.

        Unlike take_batch there is no coalescing window — the decode
        segment cadence provides natural coalescing — but a positive
        ``wait_s`` blocks up to that long for the FIRST compatible request
        (the idle-loop case). Returns [] when nothing compatible arrived in
        time, and None when the queue is closed and drained (the caller's
        exit signal). Expired requests are shed on every wake-up."""
        if max_take < 1:
            return []
        t_end = time.monotonic() + wait_s
        with self._cond:
            while True:
                if self.heartbeat is not None:
                    self.heartbeat()
                now = time.monotonic()
                self._shed_expired_locked(now)
                if self._items:
                    k = key if key is not None else self._items[0].batch_key()
                    compat = self._compat_locked(k, max_take)
                    if compat:
                        return self._take_locked(compat, max_take)
                elif self._closed:
                    return None
                if now >= t_end:
                    return []
                self._cond.wait(timeout=max(t_end - now, 0.001))

    # -- lifecycle / introspection ---------------------------------------

    def close(self, drain: bool = True) -> None:
        """Stop admitting. drain=True leaves queued requests for the
        scheduler to finish; drain=False sheds them immediately."""
        with self._cond:
            self._closed = True
            if not drain:
                self._shed_pending_locked()
            self._cond.notify_all()

    def _shed_pending_locked(self) -> int:
        n = len(self._items)
        for r in self._items:
            self._queued_tokens -= r.billable_tokens
            if self.on_shed is not None:
                self.on_shed(r, ShedReason.SHUTDOWN)
            if not r.future.done():
                r.future.set_exception(RequestShed(ShedReason.SHUTDOWN))
        self._items = []
        return n

    def shed_pending(self) -> int:
        """Fail every still-queued request with a typed SHUTDOWN shed —
        the scheduler's drain-timeout escape hatch: when the engine thread
        overruns its drain window, nothing may be left hanging on a future
        nobody will ever resolve. Returns the number shed."""
        with self._cond:
            n = self._shed_pending_locked()
            self._cond.notify_all()
            return n

    def cancel_where(self, pred) -> list[ServeRequest]:
        """Remove every queued request matching ``pred`` and release its
        token bill — the queue half of request cancellation. Deliberately
        resolution-free: the SCHEDULER owns the terminal bookkeeping
        (metrics, the future), so
        this only mutates queue state, symmetric with the take paths.
        ``pred`` runs under the queue lock — it must be cheap and must not
        take other serve locks except leaves (the stream idle probe)."""
        with self._cond:
            out = [r for r in self._items if pred(r)]
            if not out:
                return []
            gone = set(id(r) for r in out)
            self._items = [r for r in self._items if id(r) not in gone]
            for r in out:
                self._queued_tokens -= r.billable_tokens
            self._cond.notify_all()
            return out

    def requeue(self, req: ServeRequest) -> None:
        """Re-admit an EVICTED request (watchdog recovery, serve/inflight.py
        and serve/scheduler.py): no admission checks, no on_admit hook — it
        was already admitted and counted in its first life, and its future
        is still the one the caller holds. Its token bill re-enters the
        queue budget (the slots it vacated stopped billing at take).
        Appended even after close(): a drain must finish evicted work, not
        strand it; the drain's take paths serve everything still queued
        before exiting."""
        with self._cond:
            self._items.append(req)
            self._queued_tokens += req.billable_tokens
            self._cond.notify_all()

    def head_snapshot(self) -> tuple[tuple, float] | None:
        """(batch_key, enqueued_at) of the head-of-line request, or None —
        the in-flight scheduler's fairness rule (a head whose key can't
        ride the resident loop eventually forces a drain) reads it."""
        with self._lock:
            if not self._items:
                return None
            head = self._items[0]
            return head.batch_key(), head.enqueued_at

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def queued_tokens(self) -> int:
        with self._lock:
            return self._queued_tokens
