"""Micro-batching scheduler: many concurrent requests, one engine thread.

The engine already solves the hard problem — a list of prompts becomes
bucketed, fixed-shape device batches (backend/engine.py) — but it is an
offline API: someone must hand it the list. This scheduler is that someone
for online traffic. Requests arrive on arbitrary threads (HTTP handlers,
strategy rounds), sit in the bounded RequestQueue, and ONE scheduler thread
coalesces compatible requests (same max_new_tokens + GenerationConfig) into
shared backend.generate calls under a max-wait/max-batch policy:

- heavy load: batches fill to ``max_batch`` immediately — throughput-optimal,
  the engine's bucketing amortizes prefill+decode across the batch;
- light load: a lone request waits at most ``max_wait_s`` before dispatching
  alone — latency stays bounded instead of waiting for company that never
  comes (the standard micro-batching latency/throughput dial, BASS
  arXiv:2404.15778 §3).

Single-threaded engine access is load-bearing, not incidental:
TorchBackend's CUDA graphs, stats, prefix cache and dispatch counter are not
thread-safe.
Here serialization happens per engine BATCH, after coalescing — the lock
contention becomes the batching opportunity.

QueuedBackend closes the loop for the strategy layer: it implements the
Backend protocol by submitting each prompt of a strategy round as its own
queued request and waiting on the futures. Concurrent strategy runs (e.g.
two /v1/summarize requests in flight) therefore interleave their map/collapse
rounds into shared engine batches — re-entrant batch submission without the
strategies knowing the serving layer exists.

Fault tolerance (serve/supervisor.py, opt-in via ``supervisor=``; the HTTP
server opts in by default): engine dispatch failures are classified
(transient / resource-exhausted / poison / fatal), survivors retried under
bounded jittered backoff with a per-request budget, crashing batches
bisected to quarantine the poison request (typed RequestFailed on ITS
future, everyone else completes), and repeated resource failures step a
degradation ladder down (shrink batch -> no spec -> no cache inserts ->
brownout) with probed recovery. Without a supervisor the pre-supervision
contract holds: a failure resolves every rider with the raw error.

Copy of ``vnsum_tpu/serve/scheduler.py``; only the imports and the names of
the device and its engine differ. One repair: ``close()`` waits for a
successor thread that watchdog recovery has installed but not yet started
(``_join_loop_thread``); the JAX copy joins it at once and raises ``cannot
join thread before it is started`` when close lands in that window.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import InvalidStateError

from ..analysis.sanitizers import make_lock
from ..backend.base import Backend
from ..core.config import GenerationConfig
from ..core.logging import get_logger
from ..core.results import ServeRequestRecord
from ..obs import ObsHub, RequestTrace, reset_collector, set_collector
from .metrics import ServeMetrics
from .queue import (
    RequestCancelled,
    RequestQueue,
    RequestShed,
    ServeRequest,
    ShedReason,
)

logger = get_logger("vnsum.serve")


class _Completion:
    """What a request future resolves to: the text plus its observability
    record (the HTTP layer returns the record inline with the response)."""

    __slots__ = ("text", "record")

    def __init__(self, text: str, record: ServeRequestRecord) -> None:
        self.text = text
        self.record = record


class MicroBatchScheduler:
    def __init__(
        self,
        backend: Backend,
        *,
        max_batch: int = 8,
        max_wait_s: float = 0.01,
        max_queue_depth: int = 256,
        max_queued_tokens: int = 0,
        metrics: ServeMetrics | None = None,
        obs: ObsHub | None = None,
        trace_dir: str | None = None,
        supervisor=None,
        recorder=None,
        watchdog=None,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.backend = backend
        # drain is scoped to A server, not the backend's lifetime: a
        # backend reused across a closed-and-rebuilt scheduler (tests,
        # multi-phase benches) must simulate real sleeps/faults again
        reset_drain = getattr(backend, "reset_drain", None)
        if callable(reset_drain):
            reset_drain()
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.metrics = metrics or ServeMetrics()
        # flight recorder (obs/recorder.py): None = no black box — the
        # lifecycle paths then pay only `is None` checks (the bench A/B's
        # all-off arm). With one, every typed transition appends a
        # tuple-cheap event and anomalies (brownout entry, fatal failure,
        # quarantine, drain) snapshot the ring to disk
        self.recorder = recorder
        # fault tolerance (serve/supervisor.py): None = pre-supervision
        # contract — an engine failure resolves every rider with the raw
        # error, no retries (what the direct-API tests pin). With a
        # supervisor, dispatch failures are classified, survivors retried
        # under backoff, poison requests bisected out, and repeated
        # resource failures step the degradation ladder down
        self.supervisor = supervisor
        self._applied_rung = 0
        # (t0, engine_s, bt) of the last FAILED dispatch attempt — written
        # by _dispatch right before it raises, read by the resolvers.
        # Scheduler-thread-only state, like the backend itself
        self._attempt_ctx: tuple = (time.monotonic(), 0.0, None)
        # the batch currently inside the engine (scheduler thread writes,
        # close() snapshots on drain overrun so stuck dispatches still get
        # typed SHUTDOWN sheds instead of hanging their futures)
        self._dispatching: list[ServeRequest] | None = None
        # tracing hub (vnsum_tpu_torch.obs): None = tracing fully off — the hot
        # path then pays only `is None` checks, no allocation, no contextvar
        # writes (the < 2% overhead guarantee in tests/test_obs_serve.py)
        self.obs = obs
        # --trace-dir: host Chrome traces are dumped here by the server, and
        # the FIRST dispatched batch is wrapped in core.profiling.device_profile
        # so one torch.profiler trace lands side by side with the host
        # spans. That first batch pays the profiler's cost, so the capture
        # is one-shot, never per batch
        self._trace_dir = trace_dir
        self._profile_pending = trace_dir is not None
        self.queue = RequestQueue(
            max_depth=max_queue_depth, max_queued_tokens=max_queued_tokens,
        )
        self.queue.on_shed = self._on_shed
        self.queue.on_admit = self._on_admit
        self.queue.on_take = self._on_take
        # structured jobs (serve/gang.py): gang admission, membership
        # counts, and degraded-result marking. Always constructed —
        # gang bookkeeping is part of the serving contract; the bench A/B
        # toggles only queue.gang_affinity
        from .gang import GangRegistry

        self.gangs = GangRegistry(metrics=self.metrics)
        if supervisor is not None:
            # brownout gate: at the ladder's bottom rung new EXTERNAL
            # admissions shed with a typed 503 + Retry-After; the gate call
            # doubles as the recovery probe so an idle browned-out server
            # still heals
            self.queue.degraded = supervisor.admission_gate
        # -- request cancellation (DELETE /v1/requests/<id> + disconnects) --
        # trace ids with a standing cancel request, LRU-capped. Written by
        # HTTP handler threads (cancel()), read by the scheduler thread at
        # every lifecycle boundary; keeping ids after their requests resolve
        # is what makes DELETE idempotent (a re-DELETE of a finished cancel
        # answers from here) and closes the submit/cancel race for fan-out
        # siblings that had not reached the queue yet
        self._cancel_lock = make_lock("serve.cancel")
        self._cancelled_ids: OrderedDict[str, str] = OrderedDict()  # guarded by: _cancel_lock
        self.cancel_max_tracked = 4096
        # idle-consumer cancel window: a streaming request whose consumer
        # stopped popping for this long (disconnect with no resume) is
        # cancelled by the sweep. None = disabled (library default; the
        # HTTP server arms it via --stream-idle-timeout-s)
        self.stream_idle_timeout_s: float | None = None
        # bench-only A/B lever (a serving bench's cancel phase):
        # False skips the per-iteration cancel sweeps so the unused-path
        # overhead is measurable against the same build. Never exposed as
        # an operator flag — cancellation is part of the serving contract
        self.cancellation_enabled = True
        self._closed = False
        # liveness (serve/watchdog.py): None = unmonitored (the pre-watchdog
        # contract, and the bench A/B's off arm). With a Watchdog, the loop
        # thread registers a heartbeat (beaten from the queue's wait loops,
        # so an idle server still ticks), every engine dispatch is stamped
        # with a token-derived wall-clock budget, and a dispatch past budget
        # is recovered by recover_hung_dispatch ON THE WATCHDOG THREAD:
        # riders resolve typed RequestFailed(HUNG) and this loop thread is
        # REPLACED — the wedged one is fenced off by _stale_thread() checks
        # at every boundary, so its late return can never double-resolve
        self.watchdog = watchdog
        self._hb = None
        if watchdog is not None:
            self._hb = watchdog.register("scheduler", kind="loop")
            self.queue.heartbeat = self._hb.beat
            watchdog.on_hung_dispatch = self.recover_hung_dispatch
        self._thread = threading.Thread(
            target=self._loop, name="vnsum-serve-scheduler", daemon=True
        )
        self._thread.start()

    # -- submission ------------------------------------------------------

    def submit(
        self,
        prompt: str,
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        deadline: float | None = None,
        internal: bool = False,
        reference: str | None = None,
        cache_hint: str | None = None,
        trace: RequestTrace | None = None,
        trace_id: str | None = None,
        trace_owned: bool = False,
        stream=None,
        gang: str = "",
    ):
        """Admit one prompt; returns a Future resolving to a _Completion.
        Raises RequestShed synchronously when admission control rejects.
        ``internal=True`` marks fan-out of already-admitted work (strategy
        rounds riding a QueuedBackend): depth/token admission is skipped —
        the request-level gate is check_admission — while deadline and
        shutdown shedding still apply. ``reference`` rides the request as
        per-row speculation metadata (never part of the batch key);
        ``cache_hint`` rides the same way for the prefix KV cache — it
        bounds backend block insertion AND clusters shared-prefix requests
        into the same engine batch (queue.take_batch). When the backend
        exposes a prefix cache and a token budget is configured, the
        request is billed only its UNCACHED tokens at admission.

        Tracing: an entry point that already owns a RequestTrace (the HTTP
        layer, a strategy's QueuedBackend) passes it via ``trace`` — this
        prompt claims one sub-track on it and the owner finalizes it.
        ``trace_owned=True`` says the caller made the SAMPLING decision,
        whatever it was: with trace=None it means "sampled out", and the
        scheduler must not re-draw per fanned-out prompt (which would both
        distort the configured rate and fragment one request into
        single-prompt traces). Only a bare submit (no owner, ObsHub
        configured) samples here, so direct API users get timelines too.
        ``trace_id`` overrides the queue-derived correlation id either
        way.

        ``stream`` is a serve/stream.StreamChannel the scheduler pushes
        decode-progress text into (the HTTP layer's SSE source).

        ``gang`` marks this prompt a member of a structured job
        (serve/gang.py): the queue's take paths cluster same-gang rows into
        one slot generation."""
        req = ServeRequest(
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            config=config,
            reference=reference,
            cache_hint=cache_hint,
            deadline=deadline,
            est_tokens=self.backend.count_tokens(prompt),
            trace_id=trace_id or "",
            stream=stream,
            gang_id=gang,
        )
        # admission discount: only probed when a token budget exists — the
        # probe re-tokenizes the prompt (a second pass on top of
        # count_tokens above; acceptable because the path is opt-in and a
        # cache-less backend short-circuits before encoding anything)
        if self.queue.max_queued_tokens:
            probe = getattr(self.backend, "cached_prefix_tokens", None)
            if callable(probe):
                req.cached_tokens = min(
                    probe(prompt, cache_hint), req.est_tokens
                )
        if trace is not None:
            req.trace = trace
            req.trace_track = trace.next_track()
        elif not trace_owned and self.obs is not None:
            t = self.obs.start_request(req.trace_id)
            if t is not None:
                req.trace, req.own_trace = t, True
                req.trace_track = t.next_track()
        # the admit is counted by the queue's on_admit hook, under the queue
        # lock, so metrics can never show a completion before its submit
        fut = self.queue.submit(req, force=internal)  # raises RequestShed
        if gang:
            # AFTER admission: a shed prompt never joins its gang
            self.gangs.note_member(gang)
        return fut

    def check_admission(self, est_tokens: int = 0) -> None:
        """Request-level admission gate for entry points that fan out via
        internal submits; sheds are counted in metrics like any other."""
        try:
            self.queue.check_admission(est_tokens)
        except RequestShed as e:
            self.metrics.observe_shed(e.reason)
            self._fr("shed", reason=e.reason.value)
            raise

    def admit_gang(self, gang_id: str, est_tokens: int = 0):
        """Gang admission (serve/gang.py): ONE pass through the
        request-level admission gate admits the whole fan-out, and every
        internal submit riding the returned handle's gang id is
        admission-exempt. Raises the typed RequestShed on rejection
        (counted like any other shed); on success the caller owns the
        handle and must finish() it when the request terminally
        resolves."""
        self.check_admission(est_tokens)  # raises RequestShed
        return self.gangs.open(gang_id)

    def _on_take(self, batch: list[ServeRequest]) -> None:
        """Queue on_take hook (runs under the queue lock at the take commit
        point): count takes where the affinity pick landed >= 2 siblings of
        one gang in the same batch/slot generation."""
        if len(batch) < 2:
            return
        seen: dict[str, int] = {}
        for r in batch:
            if r.gang_id:
                n = seen.get(r.gang_id, 0) + 1
                if n == 2:
                    self.metrics.observe_gang_affinity_pick()
                seen[r.gang_id] = n

    def _fr(self, kind: str, rid: str = "", **fields) -> None:
        """Flight-recorder append, free when no recorder is armed."""
        if self.recorder is not None:
            self.recorder.record(kind, rid, **fields)

    # -- cancellation -----------------------------------------------------

    def cancel(self, rid: str, *, reason: str = "api") -> dict:
        """Gang-cancel every live request whose trace_id is ``rid`` —
        fan-out children share the parent's trace_id, so one DELETE
        reclaims the whole gang. Queued requests are removed and resolved
        HERE (this thread owns no engine state, and the queue removal is
        atomic under its lock); engine-side residents, taken-but-pending
        requests, and the in-flight one-shot batch are MARKED and reclaimed
        by the scheduler thread at the next segment boundary (the engine is
        single-threaded by contract — only its thread may touch slots).

        Idempotent: a rid already marked (or already terminal) re-answers
        with zero counts. Returns {"cancelled_queued", "cancel_pending", "known"}."""
        with self._cancel_lock:
            already = rid in self._cancelled_ids
        removed = self.queue.cancel_where(lambda r: r.trace_id == rid)
        # racy read of scheduler-thread state for the COUNT only (stale =
        # off by one, never a crash); the authoritative reclaim runs on the
        # scheduler thread at the next segment boundary
        pending = [] if self.cancellation_enabled is False else [
            r for r in self._stranded_snapshot() if r.trace_id == rid
        ]
        known = bool(removed or pending or already)
        if known:
            with self._cancel_lock:
                self._cancelled_ids[rid] = reason
                self._cancelled_ids.move_to_end(rid)
                while len(self._cancelled_ids) > self.cancel_max_tracked:
                    self._cancelled_ids.popitem(last=False)
        for r in removed:
            self._resolve_cancelled(r, "queued", reason)
        return {
            "cancelled_queued": len(removed),
            "cancel_pending": len(pending),
            "known": known,
        }

    def _cancel_reason_for(self, r: ServeRequest) -> str | None:
        """The standing cancel reason for ``r`` (gang-marked trace id or an
        idle streaming consumer), or None. The unlocked emptiness probe is
        the fast path: with no cancels and no idle window armed this is two
        attribute reads per call."""
        if not self.cancellation_enabled:
            return None
        # lint-allow[guarded-by]: unlocked EMPTINESS probe only — a stale read delays detection by one boundary; the authoritative lookup below holds the lock
        if self._cancelled_ids:
            with self._cancel_lock:
                reason = self._cancelled_ids.get(r.trace_id)
            if reason is not None:
                return reason
        t = self.stream_idle_timeout_s
        if (
            t is not None
            and r.stream is not None
            and r.stream.idle_for() > t
        ):
            return "disconnect"
        return None

    def _cancel_sweep(self) -> None:
        """Scheduler-thread sweep at lifecycle boundaries: pull cancelled
        (or consumer-abandoned) requests out of the queue and resolve them.
        Residents/pending are swept by the in-flight subclass; the one-shot
        batch is checked inside _dispatch."""
        if not self.cancellation_enabled:
            return
        # lint-allow[guarded-by]: unlocked EMPTINESS probe only — the per-iteration fast path; a stale read delays one sweep, the matching reads hold the lock
        if not self._cancelled_ids and self.stream_idle_timeout_s is None:
            return  # unlocked fast path: nothing can match
        removed = self.queue.cancel_where(
            lambda r: self._cancel_reason_for(r) is not None
        )
        for r in removed:
            self._resolve_cancelled(
                r, "queued", self._cancel_reason_for(r) or "disconnect"
            )

    def _resolve_cancelled(self, r: ServeRequest, stage: str,
                           reason: str = "api") -> None:
        """Terminal cancellation bookkeeping — the one funnel every cancel
        path ends in: metrics (stage-labeled; disconnect-triggered ones
        counted separately), preempt-pin release, the owned-trace
        finalization, the stream close, and the future."""
        self.metrics.observe_cancel(stage)
        if reason == "disconnect":
            self.metrics.observe_cancel_disconnect()
        self._fr("cancel", rid=r.trace_id, stage=stage, reason=reason)
        self._release_preempt_pins(r)
        if r.own_trace and r.trace is not None and self.obs is not None:
            self.obs.finish_request(r.trace, f"cancelled:{reason}")
            r.trace = None
        if r.stream is not None:
            # deltas already buffered stay poppable until close; a consumer
            # that is still attached sees the future's typed exception as
            # its terminal event, one that is gone stops costing memory
            r.stream.close()
        if not r.future.done():
            try:
                r.future.set_exception(RequestCancelled(stage, reason))
            # lint-allow[swallowed-exception]: losing the done()-check race means the scheduler thread resolved this future first — it is already answered, and the cancel sweep must keep going for the rest
            except InvalidStateError:
                pass

    def submit_many(self, prompts, references=None, cache_hints=None, **kw):
        """Admit a round of prompts atomically-ish: if any prompt is shed at
        admission, already-admitted siblings are left to complete (they
        occupy queue slots either way) and the shed propagates to the
        caller — a strategy round is all-or-nothing for its caller.
        ``references`` optionally aligns one speculation reference per
        prompt; ``cache_hints`` one prefix-cache hint per prompt."""
        if references is None:
            references = [None] * len(prompts)
        if cache_hints is None:
            cache_hints = [None] * len(prompts)
        return [
            self.submit(p, reference=r, cache_hint=h, **kw)
            for p, r, h in zip(prompts, references, cache_hints)
        ]

    def generate_sync(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        deadline: float | None = None,
        internal: bool = False,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
        trace: RequestTrace | None = None,
        trace_id: str | None = None,
        trace_owned: bool = False,
        gang: str = "",
    ) -> list[_Completion]:
        futs = self.submit_many(
            prompts, references=references, cache_hints=cache_hints,
            max_new_tokens=max_new_tokens,
            config=config, deadline=deadline, internal=internal,
            trace=trace, trace_id=trace_id, trace_owned=trace_owned,
            gang=gang,
        )
        # lint-allow[unbounded-blocking-wait]: externally bounded — these are request futures EVERY scheduler path resolves (success, typed failure, shed; drain-overrun sheds cover even a wedged engine, and the watchdog resolves hung dispatches typed)
        return [f.result() for f in futs]

    def backend_view(
        self,
        deadline: float | None = None,
        trace: RequestTrace | None = None,
        trace_id: str | None = None,
        gang: str = "",
    ) -> "QueuedBackend":
        """A Backend-protocol view whose generate() routes through this
        scheduler — hand it to a strategy to make its rounds coalesce with
        everyone else's. A ``trace`` makes every round's prompt record its
        spans on that ONE request timeline (per-prompt sub-tracks).
        ``gang`` (serve/gang.py) stamps
        every fanned-out prompt with the request's structured-job id AND
        unlocks the view's streaming submit_round/harvest protocol for
        strategies that overlap their reduce with the map fan-out."""
        return QueuedBackend(self, deadline=deadline, trace=trace,
                             trace_id=trace_id, gang=gang)

    # -- scheduler thread ------------------------------------------------

    def _on_admit(self, req: ServeRequest) -> None:
        """Queue on_admit hook (runs under the queue lock): count the
        submit BEFORE the scheduler can take the request."""
        self.metrics.observe_submit()
        if req.stream is not None:
            self.metrics.observe_stream_request()
        self._fr("admit", rid=req.trace_id, tokens=req.est_tokens)

    def _on_shed(self, req: ServeRequest, reason: ShedReason) -> None:
        self.metrics.observe_shed(reason)
        self._fr("shed", rid=req.trace_id, reason=reason.value)
        self._release_preempt_pins(req)
        # scheduler-owned traces must not leak open on the shed path; the
        # hub lock is independent of the queue lock this hook runs under
        if req.own_trace and req.trace is not None and self.obs is not None:
            self.obs.finish_request(req.trace, f"shed:{reason.value}")
            req.trace = None

    def _take_limit(self) -> int:
        """Engine dispatch width: the configured max_batch, halved by the
        degradation ladder from REDUCED_BATCH down."""
        if self.supervisor is not None:
            return self.supervisor.batch_limit(self.max_batch)
        return self.max_batch

    def _stale_thread(self) -> bool:
        """True on a scheduler thread the watchdog has REPLACED: its
        dispatch was declared hung, its riders were already resolved typed,
        and a successor owns the loop — every boundary checks this so the
        abandoned thread exits without touching shared state."""
        return threading.current_thread() is not self._thread

    def _requeue_stale(self, requests) -> None:
        """A stale thread observing the fence while still HOLDING taken
        work hands it back — never drops it. The case this exists for: a
        falsely-hung dispatch (slow but alive) returns in the declaration
        window, resolves its own riders, and takes a FRESH batch off the
        queue before the fence flips; dropping that batch at the next
        stale check would strand its futures forever, the one outcome this
        package forbids. Requeue is safe here: these futures are
        unresolved (the true-hang case resolved everything via recovery,
        making this a no-op), queue.requeue admits even after close, and
        the successor applies deadline discipline as usual."""
        n = 0
        for r in requests:
            if not r.future.done():
                self.queue.requeue(r)
                n += 1
        if n:
            logger.warning(
                "stale scheduler thread handed %d taken request(s) back "
                "to the queue for the successor", n,
            )

    def _loop(self) -> None:
        while True:
            if self._stale_thread():
                return  # replaced by watchdog recovery; the successor runs
            if self._hb is not None:
                self._hb.beat()
            try:
                self._cancel_sweep()
                batch = self.queue.take_batch(self._take_limit(),
                                              self.max_wait_s)
            # lint-allow[swallowed-exception]: a queue bug must not kill the scheduler thread; no request was taken, so there is no future to resolve
            except Exception:  # pragma: no cover - queue bugs must not kill serving
                logger.exception("take_batch failed; scheduler continuing")
                continue
            if batch is None:
                # closed and drained: a cleanly-exited loop must stop being
                # monitored — a drained scheduler is not a stall
                if self.watchdog is not None and not self._stale_thread():
                    self.watchdog.unregister("scheduler")
                return
            try:
                self._run_batch(batch)
            except Exception as e:  # pragma: no cover - belt and braces
                # _run_batch guards backend.generate, but anything raising
                # after it (token counting, metrics) must not kill the
                # scheduler thread: callers block on these futures forever
                # and /healthz would keep reporting ok
                logger.exception("batch post-processing failed")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _run_batch(self, batch: list[ServeRequest]) -> None:
        """One coalesced batch, end to end. With a supervisor configured,
        dispatch failures go through classify -> retry/bisect -> typed
        resolution (_run_supervised); without one, a failure resolves every
        rider with the raw error — the pre-supervision contract."""
        self._dispatching = batch
        try:
            if self.supervisor is None:
                try:
                    self._dispatch(batch)
                except Exception as e:
                    if self._stale_thread():
                        # true hang: recovery resolved these typed HUNG (a
                        # no-op requeue); false positive: hand them back
                        self._requeue_stale(batch)
                        return
                    self._resolve_errored(batch, e, *self._attempt_ctx)
                return
            self._run_supervised(batch)
        finally:
            # identity-guarded: an abandoned thread waking from a hung
            # dispatch must not null out the SUCCESSOR's live batch
            if self._dispatching is batch:
                self._dispatching = None

    def _dispatch(self, batch: list[ServeRequest]) -> None:
        """One engine dispatch: resolves every future on success; on failure
        records the attempt's batch metrics/trace, stashes (t0, engine_s,
        bt) in ``_attempt_ctx`` for the resolvers, and raises."""
        # cancelled riders leave BEFORE engine work
        live = []
        for r in batch:
            reason = self._cancel_reason_for(r)
            if reason is not None:
                self._resolve_cancelled(r, "queued", reason)
            else:
                live.append(r)
        batch[:] = live
        if not batch:
            return
        head = batch[0]
        self._attempt_ctx = (time.monotonic(), 0.0, None)
        if self.recorder is not None:
            # guarded, not _fr: the riders list must not be built on the
            # recorder-less hot path (the all-off arm's contract)
            self.recorder.record("dispatch", rid=head.trace_id,
                                 occupancy=len(batch),
                                 rids=[r.trace_id for r in batch[1:]])
        # batch telemetry (vnsum_tpu_torch.obs): the BatchTrace is installed as the
        # contextvar collector for the duration of backend.generate, so the
        # engine's prefill/decode/spec-step emits land on THIS batch's track
        # and its prefill end anchors every rider's TTFT
        bt = self.obs.start_batch(len(batch)) if self.obs is not None else None
        profile_cm = contextlib.nullcontext()
        if self._profile_pending:
            # one-shot: the first dispatched batch also captures a
            # torch.profiler trace into --trace-dir, side by side with host spans
            self._profile_pending = False
            from ..core.profiling import device_profile

            profile_cm = device_profile(self._trace_dir)
        references = [r.reference for r in batch]
        if self.supervisor is not None and not self.supervisor.spec_enabled:
            # ladder rung NO_SPEC: drop speculation references so the engine
            # takes the plain decode path (greedy outputs are identical)
            references = [None] * len(batch)
        token = set_collector(bt) if bt is not None else None
        # cooperative cancel flag for the blocking one-shot program:
        # backends that expose set_cancel_poll check it at their segment
        # boundaries and stop burning device time once EVERY rider is
        # cancelled (a partial cancel can't shrink a fixed batch mid-
        # flight; the riders resolve typed after the dispatch returns).
        # The poll runs on THIS thread inside generate — _cancelled ids are
        # read under their own lock, no engine state is touched
        set_poll = getattr(self.backend, "set_cancel_poll", None)
        if callable(set_poll) and self.cancellation_enabled:
            set_poll(lambda: all(
                self._cancel_reason_for(r) is not None for r in batch
            ))
        ticket = self._wd_begin("one_shot", batch)
        t0 = time.monotonic()
        try:
            with profile_cm:
                outs = self.backend.generate(
                    [r.prompt for r in batch],
                    max_new_tokens=head.max_new_tokens,
                    config=head.config,
                    references=references,
                    cache_hints=[r.cache_hint for r in batch],
                )
        except Exception:
            engine_s = time.monotonic() - t0
            if self._stale_thread():
                # this dispatch was declared HUNG and the riders resolved
                # by the watchdog; the late error belongs to nobody
                raise
            self._finish_batch_trace(bt, 0)
            self.metrics.observe_batch(len(batch), engine_s)
            logger.exception("engine batch of %d failed", len(batch))
            self._attempt_ctx = (t0, engine_s, bt)
            raise
        finally:
            self._wd_end(ticket)
            if token is not None:
                reset_collector(token)
            if (callable(set_poll) and self.cancellation_enabled
                    and not self._stale_thread()):
                # a stale thread must not clear the SUCCESSOR's poll
                set_poll(None)
        if self._stale_thread():
            # the watchdog already resolved every rider typed HUNG and a
            # successor thread owns the loop: the late result is discarded
            # (future.done() guards would drop it anyway — skipping the
            # bookkeeping keeps metrics single-counted).
            # Belt and braces for the fence-mid-bookkeeping window: any
            # rider recovery did NOT resolve goes back to the queue
            self._requeue_stale(batch)
            return
        engine_s = time.monotonic() - t0
        if len(outs) != len(batch):
            # a zip would silently drop the tail and strand its futures
            e = RuntimeError(
                f"backend returned {len(outs)} outputs for a batch of "
                f"{len(batch)}"
            )
            logger.error(str(e))
            self._finish_batch_trace(bt, 0)
            self.metrics.observe_batch(len(batch), engine_s)
            self._attempt_ctx = (t0, engine_s, bt)
            raise e
        gen_tokens = self.backend.count_tokens_batch(outs)
        self._finish_batch_trace(bt, sum(gen_tokens))
        self.metrics.observe_batch(len(batch), engine_s, sum(gen_tokens))
        # per-request speculative-decoding attribution: backends with the
        # spec path expose take_spec_report() — per-prompt records aligned
        # with the batch, cleared on read. Engine access is single-threaded
        # (this scheduler thread), so read-after-generate cannot race.
        take_spec = getattr(self.backend, "take_spec_report", None)
        spec_report = take_spec() if callable(take_spec) else []
        if len(spec_report) != len(batch):
            spec_report = [None] * len(batch)
        # prefix-cache attribution rides the same read-after-generate hook:
        # per-prompt cached prefill tokens, aligned with the batch
        take_cache = getattr(self.backend, "take_cache_report", None)
        cache_report = take_cache() if callable(take_cache) else []
        if len(cache_report) != len(batch):
            cache_report = [0] * len(batch)
        for r, out, n_out, spec, cached in zip(
            batch, outs, gen_tokens, spec_report, cache_report
        ):
            reason = self._cancel_reason_for(r)
            if reason is not None:
                # cancelled while the batch was in the engine: the decode
                # work is sunk, but the outcome is typed CANCELLED — never
                # COMPLETE (the DELETE contract)
                self._resolve_cancelled(r, "dispatched", reason)
                continue
            rec = self._record(r, "ok", t0, engine_s, len(batch), n_out, bt)
            if spec is not None:
                rec.draft_tokens = spec.draft_tokens
                rec.accepted_tokens = spec.accepted_tokens
                rec.spec_steps = spec.verify_steps
            rec.cached_prompt_tokens = int(cached)
            self.metrics.observe_request(rec)
            self._fr("complete", rid=r.trace_id, gen_tokens=n_out)
            self._trace_request(r, t0, engine_s, bt, "ok")
            self._release_preempt_pins(r)
            if r.stream is not None:
                # the one-shot program has no observable mid-decode
                # boundary: the whole text leaves as one delta, BEFORE the
                # future resolves so the handler's drain-after-done sees it
                r.stream.push_text(out)
            if not r.future.done():
                r.future.set_result(_Completion(out, rec))

    # -- watchdog (serve/watchdog.py) -------------------------------------

    # decode-token assumption for dispatch budgets when a request carries no
    # explicit max_new_tokens (the backend default is not visible here);
    # budgets are ceilings, not estimates, so generous is correct
    WATCHDOG_DEFAULT_NEW_TOKENS = 256

    def _wd_begin(self, kind: str, batch: list[ServeRequest]):
        """Stamp one engine dispatch with its wall-clock budget (the
        bounded-dispatch contract): prompt tokens plus the decode ceiling,
        through the watchdog's base+per-token formula. None when
        unmonitored — the healthy path pays one `is None` check."""
        wd = self.watchdog
        if wd is None:
            return None
        head = batch[0]
        tokens = sum(r.est_tokens for r in batch) + len(batch) * (
            head.max_new_tokens or self.WATCHDOG_DEFAULT_NEW_TOKENS
        )
        return wd.begin_dispatch(
            "scheduler", kind, wd.dispatch_budget(tokens),
            riders=tuple(r.trace_id for r in batch), tokens=tokens,
        )

    def _wd_end(self, ticket) -> None:
        if ticket is not None:
            self.watchdog.end_dispatch(ticket)

    def recover_hung_dispatch(self, ticket) -> None:
        """Wedged-dispatch recovery — runs ON THE WATCHDOG THREAD while the
        scheduler thread is still parked inside the engine call it will
        never (or too late) return from. Everything touched here is
        thread-safe by construction (futures, metrics, the queue) or
        parked-thread state the fences make safe to read.

        One-shot dispatch: every unresolved rider fails typed
        ``RequestFailed(HUNG)`` — retryable from the client's seat. The
        ladder takes a resource strike and
        the loop thread is replaced; the abandoned one is fenced by
        ``_stale_thread()`` at every boundary. The in-flight subclass
        overrides the slot-loop kinds to REQUEUE instead (the hang there is
        the loop's fault, not the riders')."""
        from .supervisor import FailureClass, RequestFailed

        # FENCE FIRST: installing the (unstarted) successor flips
        # _stale_thread() for the wedged thread before any shared state is
        # touched — a dispatch that limps back at budget+epsilon hits a
        # stale check at its next boundary instead of racing this recovery
        # (the residual window is the boundary check itself; future.done()
        # guards bound what a loser of that race can do to
        # double-bookkeeping, never corruption)
        successor = self._fence_replacement()
        riders = [r for r in (self._dispatching or [])
                  if not r.future.done()]
        exc = RequestFailed(
            FailureClass.HUNG,
            detail=(f"engine dispatch exceeded its {ticket.budget_s:.1f}s "
                    f"watchdog budget ({ticket.kind})"),
        )
        if riders:
            logger.critical(
                "watchdog recovery: failing %d rider(s) of the hung %s "
                "dispatch typed HUNG", len(riders), ticket.kind,
            )
            # clock discipline: ticket timestamps live in the WATCHDOG's
            # clock space (synthetic under test) — derive the stall age
            # there, then anchor the record in this scheduler's monotonic
            # space so queue-wait math against enqueued_at stays coherent
            age = max(self.watchdog.now() - ticket.started_at, 0.0)
            t0 = time.monotonic() - age
            self._resolve_errored(riders, exc, t0, age, None)
        self._note_hang_strike()
        self._start_replacement(successor)

    def _note_hang_strike(self) -> None:
        """A hang is too-hot-operating-point evidence like an OOM: the
        degradation ladder takes a resource-class strike."""
        from .supervisor import FailureClass

        sup = self.supervisor
        if sup is None:
            return
        self.metrics.observe_failure(FailureClass.HUNG.value)
        sup.note_failure(FailureClass.HUNG)
        # rung EFFECTS still apply lazily on the (new) engine thread at its
        # next dispatch — _apply_rung stays scheduler-thread-only

    def _fence_replacement(self) -> threading.Thread:
        """Create the successor loop thread WITHOUT starting it and install
        it as ``self._thread`` — reassignment IS the fence: from this
        instant the wedged thread reads ``_stale_thread() == True`` at
        every boundary and exits without touching shared state (its
        in-flight engine call is sunk cost). Recovery mutates shared state
        between this call and ``_start_replacement``, single-threaded."""
        t = threading.Thread(
            target=self._loop, name="vnsum-serve-scheduler", daemon=True
        )
        self._thread = t
        return t

    def _start_replacement(self, successor: threading.Thread) -> None:
        """Recovery's last act: re-beat the heartbeat (the successor must
        not start life already stalled) and let it serve."""
        if self._hb is not None:
            self._hb.beat()
        successor.start()
        logger.warning("watchdog recovery: scheduler thread replaced")

    # -- supervision (serve/supervisor.py) --------------------------------

    def _run_supervised(self, batch: list[ServeRequest]) -> None:
        """Dispatch with recovery, entirely on the scheduler thread: every
        path resolves every future. ``work`` is a stack of sub-batches —
        retries and bisection halves go back on it until everything is
        resolved (success, typed failure, or shed)."""
        sup = self.supervisor
        work: list[list[ServeRequest]] = [batch]
        while work:
            if self._stale_thread():
                # watchdog recovery owns the hung dispatch's riders; any
                # OTHER unresolved work this thread still holds (a batch
                # taken in the declaration window) goes back to the queue
                self._requeue_stale([r for g in work for r in g])
                return
            group = [r for r in work.pop() if not r.future.done()]
            # deadline discipline survives retries: an expired rider is
            # shed typed, never redispatched
            now = time.monotonic()
            for r in [r for r in group if r.expired(now)]:
                self._shed_taken(r, ShedReason.DEADLINE)
            group = [r for r in group if not r.expired(now)]
            if not group:
                continue
            # ladder rung REDUCED_BATCH+: never dispatch wider than the
            # degraded limit, even for batches taken before the step-down
            limit = sup.batch_limit(self.max_batch)
            if len(group) > limit:
                work.append(group[limit:])
                group = group[:limit]
            self._apply_rung()
            try:
                self._dispatch(group)
                sup.record_success()
                self._apply_rung()
            except Exception as e:
                if self._stale_thread():
                    # late error from a dispatch already declared HUNG —
                    # recovery resolved ITS riders; hand anything else back
                    self._requeue_stale(
                        [r for g in work for r in g] + group
                    )
                    return
                self._resolve_dispatch_failure(group, e, work)

    def _resolve_dispatch_failure(
        self, group: list[ServeRequest], e: Exception,
        work: list[list[ServeRequest]],
    ) -> None:
        """Decide each rider's fate after one failed dispatch: fail typed
        (fatal / out of budget / poisoned alone), bisect to isolate, or push
        a backed-off retry onto ``work``."""
        from .supervisor import FailureClass

        sup = self.supervisor
        cls = sup.classify(e)
        self.metrics.observe_failure(cls.value)
        self._fr("fault", rid=group[0].trace_id, failure_class=cls.value,
                 group=len(group))
        sup.note_failure(cls)
        self._apply_rung()
        if cls is FailureClass.FATAL:
            self._resolve_failed(group, e, cls)
            return
        if cls is FailureClass.POISON:
            # deterministic input error: retrying burns device time. Alone,
            # the request IS the poison — quarantine typed; in company,
            # bisect so innocent riders escape through the clean half
            if len(group) == 1:
                self.metrics.observe_quarantine()
                self._dump("quarantine")
                self._resolve_failed(group, e, cls)
            else:
                self._bisect(group, work)
            return
        # TRANSIENT / RESOURCE: charge the failed attempt to every rider
        for r in group:
            r.attempts += 1
        budget = sup.policy.max_attempts
        if any(r.attempts >= budget for r in group):
            if len(group) > 1:
                # the group burned its budget together — quarantine by
                # bisection instead of failing innocents with the
                # stranger's error
                self._bisect(group, work)
                return
            # a lone request out of budget is terminal. A TRANSIENT-class
            # error that failed every attempt, finally with no one else to
            # blame, is the quarantine verdict; RESOURCE keeps its class
            # (the operating point, not the request, is at fault)
            final = (FailureClass.POISON if cls is FailureClass.TRANSIENT
                     else cls)
            if final is FailureClass.POISON:
                self.metrics.observe_quarantine()
                self._dump("quarantine")
            self._resolve_failed(group, e, final)
            return
        delay = sup.backoff_s(max(r.attempts for r in group))
        self.metrics.observe_retry(len(group))
        self.metrics.observe_backoff(delay)
        for r in group:
            self._trace_fault(r, "retry", cls.value, delay)
        logger.warning(
            "retrying batch of %d after %s failure (backoff %.3fs)",
            len(group), cls.value, delay,
        )
        # the backoff sleeps the scheduler thread: queued healthy work waits
        # it out too, which is deliberate — the engine just failed, and
        # hammering it with the next batch is how failure storms start
        time.sleep(delay)
        work.append(group)

    def _bisect(self, group: list[ServeRequest],
                work: list[list[ServeRequest]]) -> None:
        """Split a crashing batch to isolate its poison: halves re-dispatch
        independently; the culprit bottoms out alone and fails typed while
        every innocent rider escapes through a clean half."""
        self.metrics.observe_bisect()
        self._fr("bisect", rid=group[0].trace_id, group=len(group))
        mid = len(group) // 2
        logger.warning(
            "bisecting crashing batch of %d to quarantine the fault",
            len(group),
        )
        for r in group:
            self._trace_fault(r, "bisect", None, 0.0)
        work.append(group[mid:])
        work.append(group[:mid])

    def _dump(self, reason: str) -> None:
        """Anomaly-triggered flight-recorder dump (no-op without one)."""
        if self.recorder is not None:
            self.recorder.dump(reason)

    def _resolve_failed(self, group, e, failure_class) -> None:
        """Terminal typed failure: every rider's future gets RequestFailed
        carrying the class and the last underlying error."""
        from .supervisor import FailureClass, RequestFailed

        if failure_class is FailureClass.FATAL:
            # the engine itself is gone: snapshot the black box while the
            # lead-up is still in the ring
            self._dump("fatal")
        t0, engine_s, bt = self._attempt_ctx
        exc = RequestFailed(failure_class, detail=str(e), cause=e)
        self._resolve_errored(group, exc, t0, engine_s, bt)

    def _release_preempt_pins(self, r: ServeRequest) -> None:
        """Drop the prefix-cache pins a preemption took (serve/inflight.py):
        the blocks were held so a preempted request's cached prefix
        survives LRU until it terminally resolves — every resolution path
        (complete, errored, shed) funnels through here. Idempotent."""
        pins, r.preempt_pins = r.preempt_pins, []
        for cache, match in pins:
            cache.release(match)

    def _shed_taken(self, r: ServeRequest, reason: ShedReason) -> None:
        """Typed shed for a request already taken off the queue (deadline
        expiry at retry, drain overrun): metrics + owned-trace finalization
        + the future, mirroring the queue-side shed hook."""
        self.metrics.observe_shed(reason)
        self._fr("shed", rid=r.trace_id, reason=reason.value)
        self._release_preempt_pins(r)
        if r.own_trace and r.trace is not None and self.obs is not None:
            self.obs.finish_request(r.trace, f"shed:{reason.value}")
            r.trace = None
        if not r.future.done():
            try:
                r.future.set_exception(RequestShed(reason))
            # lint-allow[swallowed-exception]: losing the done()-check race means the scheduler thread resolved this future first — it is already answered, and the shed loop must keep going for the rest
            except InvalidStateError:
                pass

    def _trace_fault(self, r: ServeRequest, event: str,
                     failure_class: str | None, delay: float) -> None:
        """Fault-path observability on the request's own timeline: one span
        per retry/bisect so /debug/trace shows WHY a request's e2e latency
        grew (class + attempt count + backoff)."""
        tr = r.trace
        if tr is None:
            return
        args = {"attempts": r.attempts}
        if failure_class:
            args["failure_class"] = failure_class
        tr.add(f"fault_{event}", time.monotonic(), delay, r.trace_track,
               **args)

    def _apply_rung(self) -> None:
        """Lazily apply ladder effects on the engine thread (the backend is
        not thread-safe, so rung changes noted elsewhere take effect at the
        next dispatch): prefix-cache insert gating, the step counters, and
        the transition log line."""
        sup = self.supervisor
        rung = int(sup.rung)
        if rung == self._applied_rung:
            return
        down = rung > self._applied_rung
        for _ in range(abs(rung - self._applied_rung)):
            self.metrics.observe_degraded(down)
        logger.warning(
            "degradation ladder: rung %d -> %d (%s)",
            self._applied_rung, rung, "step-down" if down else "recovery",
        )
        self._fr("rung_change", from_rung=self._applied_rung, to_rung=rung)
        from .supervisor import Rung

        if down and rung >= Rung.BROWNOUT:
            # brownout entry is the post-mortem moment: dump the ring with
            # the failure storm that drove the ladder down still in it
            self._dump("brownout")
        self._applied_rung = rung
        toggle = getattr(self.backend, "set_prefix_cache_inserts", None)
        if callable(toggle):
            toggle(sup.cache_inserts_enabled)

    def _resolve_errored(self, batch, e, t0, engine_s, bt) -> None:
        from .supervisor import RequestFailed

        reason = (
            e.failure_class.value if isinstance(e, RequestFailed) else "error"
        )
        for r in batch:
            rec = self._record(r, "error", t0, engine_s, len(batch), 0, bt)
            self.metrics.observe_request(rec)
            self._fr("failed", rid=r.trace_id, reason=reason)
            self._trace_request(r, t0, engine_s, bt, "error")
            self._release_preempt_pins(r)
            if not r.future.done():
                r.future.set_exception(e)

    def _finish_batch_trace(self, bt, gen_tokens: int) -> None:
        if bt is not None:
            self.obs.finish_batch(bt, gen_tokens)

    def _trace_request(self, r: ServeRequest, t0: float, engine_s: float,
                       bt, status: str) -> None:
        """Append this dispatch's spans to the request's trace: queue wait,
        engine residency (tagged with the batch it rode), postprocess
        (detokenize-side token counting + record assembly). One call per
        (request, batch) — a summarize request accumulates one span triple
        per strategy-round prompt, each on its own sub-track."""
        tr = r.trace
        if tr is None:
            return
        track = r.trace_track
        t1 = t0 + engine_s
        tr.add("queue_wait", r.enqueued_at, max(t0 - r.enqueued_at, 0.0),
               track, request_id=r.request_id)
        tr.add("engine", t0, engine_s, track, status=status,
               batch=bt.batch_id if bt is not None else None,
               occupancy=bt.occupancy if bt is not None else None)
        tr.add("postprocess", t1, max(time.monotonic() - t1, 0.0), track)
        if r.own_trace and self.obs is not None:
            self.obs.finish_request(tr, status)

    def _record(self, r, status, t0, engine_s, batch_size, gen_tokens,
                bt=None):
        now = time.monotonic()
        # TTFT anchor: the batch's host-observed prefill end when the
        # backend emitted one; the fused one-shot program has no observable
        # midpoint, so the whole engine call is the honest upper bound —
        # reported in the record but EXCLUDED from the TTFT histogram
        # (metrics.observe_request keys on ttft_anchored)
        anchored = bt is not None and bt.first_token_at is not None
        first_token = bt.first_token_at if anchored else t0 + engine_s
        return ServeRequestRecord(
            request_id=r.request_id,
            status=status,
            trace_id=r.trace_id,
            queue_wait_s=max(t0 - r.enqueued_at, 0.0),
            engine_s=engine_s,
            total_s=max(now - r.enqueued_at, 0.0),
            ttft_s=max(first_token - r.enqueued_at, 0.0),
            ttft_anchored=anchored,
            batch_size=batch_size,
            prompt_tokens=r.est_tokens,
            generated_tokens=gen_tokens,
        )

    # -- lifecycle -------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admitting; drain=True runs remaining queued batches to
        completion before the scheduler thread exits.

        Drain overrun is not a warning-and-hang: when the scheduler thread
        (stuck dispatch, fault storm) misses the window, every still-queued
        AND currently-dispatching request gets a typed
        RequestShed(SHUTDOWN) on its future — callers blocked on result()
        unblock with the shed instead of hanging forever. The thread is a
        daemon and every resolution site guards future.done(), so a late
        engine completion is dropped harmlessly."""
        self._closed = True
        # drain beats an in-flight SLEEP: backends with a simulated latency
        # model (FakeBackend, and the injected `latency` fault kind) abort
        # their sleeps on request_drain, so a graceful SIGTERM never waits
        # out fake device time — outputs are unaffected (the sleep is pure
        # simulation), only the wall clock shrinks. Real backends simply
        # don't expose the hook
        drain_hook = getattr(self.backend, "request_drain", None)
        if callable(drain_hook):
            drain_hook()
        self.queue.close(drain=drain)
        alive = self._join_loop_thread(timeout)
        if self.watchdog is not None:
            # closed (drained or overrun): either way this scheduler stops
            # being monitored — shutdown must not read as a stall
            self.watchdog.unregister("scheduler")
        if alive:
            shed_queued = self.queue.shed_pending()
            stranded = self._stranded_snapshot()
            for r in stranded:
                self._shed_taken(r, ShedReason.SHUTDOWN)
            logger.warning(
                "scheduler did not drain within %.1fs; shed %d queued and "
                "%d in-flight request(s) with typed SHUTDOWN",
                timeout, shed_queued, len(stranded),
            )

    def _join_loop_thread(self, timeout: float) -> bool:
        """Join the loop thread within ``timeout``; True if it is still
        alive (or not yet started) when the budget runs out.

        Watchdog recovery installs an UNSTARTED successor as
        ``self._thread`` (``_fence_replacement``) and starts it only after
        resolving the hung dispatch's riders (``_start_replacement``): a
        close landing in that window must wait for the start, since
        ``Thread.join`` raises on a thread that was never started. The
        thread is re-read after every wait, so a replacement installed
        while joining its predecessor is joined too."""
        deadline = time.monotonic() + timeout
        while True:
            t = self._thread
            remaining = deadline - time.monotonic()
            if t.ident is None:
                # fenced, not yet started: recovery is mid-flight
                if remaining <= 0:
                    return True
                time.sleep(min(0.01, remaining))
                continue
            t.join(timeout=max(remaining, 0.0))
            cur = self._thread
            if cur is t or time.monotonic() >= deadline:
                return cur.ident is None or cur.is_alive()

    def _stranded_snapshot(self) -> list[ServeRequest]:
        """Requests taken off the queue but not yet resolved — what a drain
        overrun must shed. The in-flight subclass adds its resident slots."""
        return list(self._dispatching or [])

    @property
    def closed(self) -> bool:
        return self._closed


class QueuedBackend:
    """Backend-protocol adapter over a MicroBatchScheduler.

    generate() fans each prompt into its own queued request and blocks until
    every future resolves, so a strategy's per-round batched call becomes N
    coalescible units — two strategies running concurrently share engine
    batches instead of serializing whole runs. Token counting delegates
    straight to the real backend (host-side, thread-safe, no queue trip).

    A RequestShed on any prompt of a round propagates to the caller: the
    strategy run is aborted with the typed shed, matching the all-or-nothing
    semantics a deadline implies. ``records`` accumulates the per-request
    observability of every completed prompt for response-inline reporting.

    Streaming protocol (serve/gang.py): ``submit_round``/``harvest`` are
    the non-blocking half of generate() — a strategy that detects them
    submits a fan-out round and harvests completions as they land, so its
    reduce phase starts building while slow map children still decode
    instead of barriering on the whole round. Plain offline backends don't
    expose the pair, so strategies fall back to the barrier path there.
    """

    name = "queued"

    def __init__(self, scheduler: MicroBatchScheduler,
                 deadline: float | None = None,
                 trace: RequestTrace | None = None,
                 trace_id: str | None = None,
                 gang: str = "") -> None:
        self.scheduler = scheduler
        self.deadline = deadline
        # ONE RequestTrace for the whole strategy run: every round's prompts
        # claim sub-tracks on it, so /debug/trace shows a summarize request
        # as one process with its map/collapse fan-out side by side
        self.trace = trace
        self.trace_id = trace_id
        # structured-job id every fanned-out prompt inherits (serve/gang.py);
        # "" = ungrouped (the raw /v1/generate path)
        self.gang_id = gang
        # streaming-summarize progress hook (serve/server.py): called with
        # the completed-prompt count after each round's completions land —
        # the SSE "progress" event source. None = no streaming
        self.progress = None
        self.records: list[ServeRequestRecord] = []  # guarded by: _lock
        # lock-order-sanitizer hook: plain threading.Lock in production
        self._lock = make_lock("serve.queued_backend")

    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list[str]:
        if not prompts:
            return []
        # internal: this is the fan-out of an already-admitted request —
        # its admission happened at the entry point (check_admission), so a
        # wide strategy round must not shed itself against the depth budget
        # trace_owned: the entry point that built this view decided the
        # sampling — a trace=None here means "sampled out", not "re-draw"
        completions = self.scheduler.generate_sync(
            prompts, max_new_tokens=max_new_tokens, config=config,
            deadline=self.deadline, internal=True, references=references,
            cache_hints=cache_hints,
            trace=self.trace, trace_id=self.trace_id, trace_owned=True,
            gang=self.gang_id,
        )
        with self._lock:
            self.records.extend(c.record for c in completions)
            done = len(self.records)
        if self.progress is not None:
            self.progress(done)
        return [c.text for c in completions]

    # -- streaming fan-out (serve/gang.py) --------------------------------

    def submit_round(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list:
        """Submit one fan-out round WITHOUT blocking: returns the futures
        aligned with ``prompts`` for ``harvest`` to drain in completion
        order."""
        if not prompts:
            return []
        futs = self.scheduler.submit_many(
            prompts, references=references, cache_hints=cache_hints,
            max_new_tokens=max_new_tokens, config=config,
            deadline=self.deadline, internal=True,
            trace=self.trace, trace_id=self.trace_id, trace_owned=True,
            gang=self.gang_id,
        )
        return futs

    def harvest(self, fut, *, tolerate_poison: bool = False) -> str | None:
        """Resolve ONE submit_round future: the text on success (progress
        fires per completion — the streaming client's per-child progress
        events), or None when ``tolerate_poison`` and the member failed
        typed POISON — the gang is marked ``partial`` and the
        caller's reduce proceeds over the survivors. Every other failure
        (transient-out-of-budget, fatal, shed, cancelled) re-raises: a
        degraded summary is a poison-only contract, infrastructure
        failures still fail the request."""
        from .supervisor import FailureClass, RequestFailed

        try:
            # lint-allow[unbounded-blocking-wait]: externally bounded — same contract as generate_sync: every scheduler path resolves request futures (success, typed failure, shed, watchdog-resolved hangs)
            c = fut.result()
        except RequestFailed as e:
            if (
                tolerate_poison
                and self.gang_id
                and e.failure_class is FailureClass.POISON
            ):
                self.scheduler.gangs.mark_partial(self.gang_id)
                with self._lock:
                    done = len(self.records)
                if self.progress is not None:
                    self.progress(done)
                return None
            raise
        with self._lock:
            self.records.append(c.record)
            done = len(self.records)
        if self.progress is not None:
            self.progress(done)
        return c.text

    def count_tokens(self, text: str) -> int:
        return self.scheduler.backend.count_tokens(text)

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        return self.scheduler.backend.count_tokens_batch(texts)
