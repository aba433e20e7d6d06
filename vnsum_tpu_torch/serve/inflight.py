"""In-flight scheduler: slot-feeding over a persistent engine decode loop.

`MicroBatchScheduler` is batch-dispatch: coalesce, call a blocking
``backend.generate``, repeat — every request that arrives mid-batch waits
out the full prefill+decode of strangers. This scheduler replaces the
dispatch loop with *slot feeding* over the backend's in-flight slot loop
(``backend.start_slot_loop``, Orca-style iteration-level scheduling): one
long-lived fixed-shape decode batch where, at every segment boundary,
finished rows are harvested and freed slots are refilled straight from the
queue (``RequestQueue.take_upto`` — admission billed per slot). Joiners get
their own chunked prefill (optionally resumed from the radix prefix cache),
so per-request TTFT is anchored at the JOINER's prefill end — not at a
shared batch's — and a request's time-to-first-token no longer includes
strangers' decode.

Policy notes:

- **compatibility**: a loop serves ONE batch key (max_new_tokens +
  GenerationConfig — the same coalescing rule as batch dispatch). Requests
  with other keys wait; compatible later arrivals may leapfrog them into
  free slots, but an incompatible head-of-line older than
  ``switch_grace_s`` stops refills so the loop drains and is rebuilt for
  the new key (bounded unfairness instead of starvation).
- **oversized prompts**: prompts beyond the loop's prompt bucket are
  rejected at admit and served through the classic batch-dispatch path
  (``_run_batch``) between segments — the offline one-shot program remains
  the path of record for them.
- **speculation**: the slot loop has no spec-decode variant; references are
  ignored in in-flight mode (greedy outputs are identical either way).
- **fault tolerance**: a loop crash (admit or segment) evicts every
  resident — slots freed, radix pins released by the loop's own finally
  paths — and, when a supervisor is configured, re-runs stranded requests
  through the SUPERVISED one-shot dispatch path grouped by batch key, so
  retry/bisect/poison-quarantine are inherited rather than re-implemented;
  the rebuilt loop then serves new work. Without a supervisor every
  stranded future fails with the raw error (legacy contract).

Everything else — submission, admission control, deadline shedding,
QueuedBackend strategy fan-out, metrics surfaces — is inherited from
MicroBatchScheduler; only the engine-side loop differs.

Copy of ``vnsum_tpu/serve/inflight.py``; only the imports and the names of
the device and its engine differ. The slot loop is
``TorchBackend.start_slot_loop``'s ``TorchSlotLoop`` (or FakeBackend's
``FakeSlotLoop``). One addition: with tracing on, each admit and each step
runs under a BatchTrace collector (``_collect``), so the loop's ``prefill``
and ``decode_seg`` spans reach /debug/trace; the JAX scheduler installs none
around its loop.
"""
from __future__ import annotations

import time

from ..backend.base import Backend
from ..core.logging import get_logger
from ..core.results import ServeRequestRecord
from ..obs import reset_collector, set_collector
from .queue import ServeRequest, ShedReason
from .scheduler import MicroBatchScheduler, _Completion

logger = get_logger("vnsum.serve.inflight")


class InflightScheduler(MicroBatchScheduler):
    def __init__(
        self,
        backend: Backend,
        *,
        slots: int | None = None,
        slot_prompt_tokens: int = 0,
        switch_grace_s: float = 0.5,
        fused_segments: int = 1,
        **kw,
    ) -> None:
        if not callable(getattr(backend, "start_slot_loop", None)):
            raise ValueError(
                f"backend {getattr(backend, 'name', backend)!r} does not "
                "expose start_slot_loop; use MicroBatchScheduler"
            )
        # set before super().__init__ — the base constructor starts the
        # scheduler thread, which reads these immediately
        self.slots = slots or kw.get("max_batch", 8)
        self.slot_prompt_tokens = slot_prompt_tokens
        self.switch_grace_s = switch_grace_s
        # fused multi-step decode: the loop dispatches N on-device segments
        # per host round-trip, so joins, cancel polls, and stream
        # deltas run at the FUSED cadence — the TTFT/goodput trade knob
        # (--fused-segments)
        self.fused_segments = max(int(fused_segments), 1)
        # live loop reference for scrape-time gauges (written only by the
        # scheduler thread; racy reads yield a stale gauge, never a crash)
        self._live_loop = None
        # taken-but-not-yet-admitted requests (scheduler-thread state; an
        # instance attribute so close() can shed them on drain overrun)
        self._pending: list[ServeRequest] = []
        super().__init__(backend, **kw)

    # -- scrape surface ---------------------------------------------------

    def slot_state(self) -> tuple[int, int] | None:
        """(slots_total, slots_busy) for /metrics, or None when no loop is
        resident yet."""
        loop = self._live_loop
        if loop is None:
            return (self.slots, 0)
        return (loop.slots, loop.active)

    # -- scheduler thread -------------------------------------------------

    def _take_limit(self) -> int:
        """Slot budget under the degradation ladder: a rebuilt loop at
        REDUCED_BATCH or below runs half the slots (a resident full-size
        loop keeps its shape — shrinking applies at the next rebuild)."""
        if self.supervisor is not None:
            return self.supervisor.batch_limit(self.slots)
        return self.slots

    def _loop(self) -> None:
        loop = None
        loop_key = None
        self._pending = []
        draining = False  # queue closed: serve what remains, then exit
        while True:
            if self._stale_thread():
                return  # replaced by watchdog recovery; the successor runs
            if self._hb is not None:
                self._hb.beat()
            try:
                self._cancel_sweep_inflight(loop)
                active = loop.active if loop is not None else 0
                if not draining and not self._pending:
                    taken = self._take(loop, loop_key, active)
                    if taken is None:
                        draining = True
                    else:
                        self._pending.extend(taken)
                if draining and not self._pending and not active:
                    self._close_loop(loop)
                    if self.watchdog is not None and not self._stale_thread():
                        self.watchdog.unregister("scheduler")
                    return
                if self._pending and not active:
                    key = self._pending[0].batch_key()
                    if loop is None or key != loop_key:
                        self._close_loop(loop)
                        loop = self._make_loop(self._pending[0])
                        loop_key = key
                if (
                    self._pending
                    and loop is not None
                    and self._pending[0].batch_key() == loop_key
                    and loop.free
                ):
                    admitted = self._admit(loop, self._pending)
                    if self._stale_thread():
                        # hung admit: the successor owns _pending now — an
                        # assignment here would clobber its taken work
                        return
                    self._pending = admitted
                if loop is not None and loop.active:
                    self._run_segment(loop)
                    if self._stale_thread():
                        # hung segment: a late record_success here would
                        # clear the very strike the recovery just charged
                        return
                    if self.supervisor is not None:
                        self.supervisor.record_success()
                        self._apply_rung()
            except Exception as e:  # exercised by tests/test_serve_faults.py
                if self._stale_thread():
                    # a late error out of a loop the watchdog already tore
                    # down and requeued: the successor owns everything now
                    return
                # a loop failure must not kill serving: every resident and
                # pending request is evicted (slots freed, radix pins
                # released by the loop's own finally paths) and resolved —
                # retried through the supervised one-shot path when a
                # supervisor is configured, failed with the raw error
                # otherwise — then the loop is rebuilt for new work
                logger.exception("in-flight loop failed; recovering")
                stranded = self._evict_all(loop, self._pending)
                loop, loop_key = None, None
                self._pending = []
                self._resolve_loop_failure(stranded, e)

    def _resolve_loop_failure(self, stranded: list[ServeRequest],
                              e: Exception) -> None:
        """Resolve every request owed an answer after a slot-loop crash.

        Supervised: the crash is classified and noted (ladder strikes
        included), then survivors are re-run through the SUPERVISED one-shot
        dispatch path (``_run_batch``) grouped by batch key — the slot
        loop's per-request decode state died with it, and the one-shot
        program recomputes from scratch, so retry/bisect/quarantine and
        "every future resolves" are inherited rather than re-implemented.
        Unsupervised: the legacy contract — every stranded future fails
        with the raw error."""
        from .supervisor import FailureClass

        sup = self.supervisor
        if sup is not None:
            cls = sup.classify(e)
            self.metrics.observe_failure(cls.value)
            sup.note_failure(cls)
            self._apply_rung()
            if not stranded:
                return
            if cls is FailureClass.FATAL:
                self._attempt_ctx = (time.monotonic(), 0.0, None)
                self._resolve_failed(stranded, e, cls)
                return
            delay = sup.backoff_s(1)
            self.metrics.observe_retry(len(stranded))
            self.metrics.observe_backoff(delay)
            for r in stranded:
                self._trace_fault(r, "retry", cls.value, delay)
            logger.warning(
                "retrying %d stranded request(s) via the one-shot path "
                "after %s loop failure (backoff %.3fs)",
                len(stranded), cls.value, delay,
            )
            time.sleep(delay)
            # group by batch key: residents share the dead loop's key, but
            # pending may already carry the NEXT key awaiting a loop switch
            # — mixing them in one generate would apply the head's params
            # to everyone
            groups: dict[tuple, list[ServeRequest]] = {}
            for r in stranded:
                groups.setdefault(r.batch_key(), []).append(r)
            for group in groups.values():
                self._run_batch(group)
            return
        now = time.monotonic()
        for r in stranded:
            adm = getattr(r, "inflight_admission", None)
            t0 = adm.admitted_at if adm is not None else now
            rec = ServeRequestRecord(
                request_id=r.request_id, status="error",
                trace_id=r.trace_id,
                queue_wait_s=max(t0 - r.enqueued_at, 0.0),
                engine_s=max(now - t0, 0.0),
                total_s=max(now - r.enqueued_at, 0.0),
                prompt_tokens=r.est_tokens,
            )
            self.metrics.observe_request(rec)
            self._fr("failed", rid=r.trace_id, reason="error")
            self._trace_request(r, t0, max(now - t0, 0.0), None, "error")
            self._release_preempt_pins(r)
            if not r.future.done():
                r.future.set_exception(e)

    def recover_hung_dispatch(self, ticket) -> None:
        """Wedged slot-loop recovery — runs ON THE WATCHDOG THREAD while
        the scheduler thread is parked inside the hung ``admit``/``step``.

        One-shot tickets (the oversized-prompt fallback) take the base
        policy: riders fail typed HUNG. Slot kinds evict and requeue
        instead: the hang is the LOOP's fault, not the riders' — so the
        loop is torn down (evict all residents, prefix blocks PINNED so the
        restart prefill resumes warm, pins released at terminal
        resolution), every resident and taken-but-unadmitted request is
        requeued, and the replacement thread rebuilds a fresh loop and
        completes them byte-identically (greedy; a sampled resident redraws
        its slot uid). The parked thread is
        fenced by ``_stale_thread()``: its late return out of the closed
        loop touches nothing."""
        if ticket.kind == "one_shot":
            super().recover_hung_dispatch(ticket)
            return
        # FENCE FIRST (see the base override): the wedged thread reads
        # _stale_thread() == True from here on, so a hung admit/step that
        # limps back mid-recovery cannot race _pending or the dying loop
        successor = self._fence_replacement()
        stranded = list(self._pending)
        self._pending = []
        loop = self._live_loop
        evictions = []
        if loop is not None:
            residents = loop.outstanding()
            if residents:
                evictions = loop.evict(residents)
            self._close_loop(loop)
        logger.critical(
            "watchdog recovery: hung %s — tearing down the slot loop, "
            "requeueing %d resident(s) + %d pending",
            ticket.kind, len(evictions), len(stranded),
        )
        for ev in evictions:
            self._requeue_eviction(ev)
        for r in stranded:
            # taken off the queue but never slot-admitted: back it goes,
            # verbatim (no engine state to unwind)
            self.queue.requeue(r)
        self._note_hang_strike()
        self._start_replacement(successor)

    def _stranded_snapshot(self) -> list[ServeRequest]:
        stranded = list(self._pending)
        loop = self._live_loop
        if loop is not None:
            stranded.extend(loop.outstanding())
        # an oversized-prompt fallback batch mid-_run_batch is in-flight
        # work too (both for drain-overrun sheds and the cancel surface)
        stranded.extend(self._dispatching or [])
        return stranded

    def _take(self, loop, loop_key, active: int):
        """One queue interaction: blocking for the head when idle,
        non-blocking slot-feeding when decoding."""
        if not active:
            return self.queue.take_upto(
                self._take_limit(), wait_s=max(self.max_wait_s, 0.05)
            )
        if loop is None or not loop.free:
            return []
        head = self.queue.head_snapshot()
        if (
            head is not None
            and head[0] != loop_key
            and time.monotonic() - head[1] > self.switch_grace_s
        ):
            # an incompatible head has waited long enough: stop refilling
            # so the resident batch drains and the loop is rebuilt for it
            return []
        return self.queue.take_upto(loop.free, key=loop_key)

    def _cancel_sweep_inflight(self, loop) -> None:
        """Cancellation at the segment boundary — the in-flight half of the
        cancel contract: queued matches leave through the base sweep,
        taken-but-unadmitted ones resolve here, and cancelled RESIDENTS are
        evicted through the same slot machinery hang recovery uses — but
        WITHOUT requeue and WITHOUT pinning their prefix
        (``evict(pin=False)``): a cancelled request is terminal, so warming
        its restart would pin blocks nobody will ever resume. Freed slots
        refill from the queue at this very boundary, which is what makes
        cancelling a saturating request hand the engine back within one
        segment."""
        if not self.cancellation_enabled:
            return
        if not self._cancelled_ids and self.stream_idle_timeout_s is None:
            return  # unlocked fast path, same contract as the base sweep
        self._cancel_sweep()
        live: list[ServeRequest] = []
        for r in self._pending:
            reason = self._cancel_reason_for(r)
            if reason is not None:
                self._resolve_cancelled(r, "queued", reason)
            else:
                live.append(r)
        self._pending = live
        if loop is None or not loop.active:
            return
        victims = [
            (r, reason) for r in loop.outstanding()
            if (reason := self._cancel_reason_for(r)) is not None
        ]
        if not victims:
            return
        evictions = loop.evict([r for r, _ in victims], pin=False)
        reasons = {id(r): why for r, why in victims}
        for ev in evictions:
            r: ServeRequest = ev.key
            self._resolve_cancelled(
                r, "resident", reasons.get(id(r), "api")
            )
        if evictions:
            logger.info(
                "cancelled %d resident slot(s) at the segment boundary",
                len(evictions),
            )

    def _requeue_eviction(self, ev) -> None:
        """THE eviction -> requeue bookkeeping of watchdog hang recovery:
        eviction count, pin carry, metrics, flight-recorder events, and the
        trace span."""
        r: ServeRequest = ev.key
        r.preemptions += 1
        if ev.pin is not None:
            r.preempt_pins.append(ev.pin)
        self.metrics.observe_preemption()
        self._fr("preempt", rid=r.trace_id, preemptions=r.preemptions)
        self._trace_fault(r, "preempt", None, 0.0)
        self.queue.requeue(r)
        self.metrics.observe_requeue()
        self._fr("requeue", rid=r.trace_id)

    def _make_loop(self, head: ServeRequest):
        loop = self.backend.start_slot_loop(
            self._take_limit(),
            max_new_tokens=head.max_new_tokens,
            config=head.config,
            prompt_tokens=self.slot_prompt_tokens,
            fused_segments=self.fused_segments,
        )
        self._live_loop = loop
        return loop

    def _close_loop(self, loop) -> None:
        if loop is not None:
            self._live_loop = None
            loop.close()

    def _evict_all(self, loop, pending: list[ServeRequest]):
        """Collect every request still owed an answer after a loop failure."""
        stranded = list(pending)
        if loop is not None:
            stranded.extend(loop.outstanding())
            self._close_loop(loop)
        self._live_loop = None
        return stranded

    # -- admission ---------------------------------------------------------

    def _admit(self, loop, pending: list[ServeRequest]) -> list[ServeRequest]:
        now = time.monotonic()
        live: list[ServeRequest] = []
        for r in pending:
            reason = self._cancel_reason_for(r)
            if reason is not None:
                # cancelled between take and slot admission: resolve before
                # any prefill work, crediting the DRR charge the take made
                self._resolve_cancelled(r, "queued", reason)
            elif r.expired(now):
                # the queue sheds expired requests it still holds; taken-but
                # -unadmitted ones are this scheduler's to shed — including
                # the owned-trace finalization the queue-side _on_shed hook
                # performs, so SLO-miss requests still reach /debug/trace
                self._shed_taken(r, ShedReason.DEADLINE)
            else:
                live.append(r)
        pending = live
        if not pending or not loop.free:
            return pending
        was_running = loop.active > 0
        items = [(r, r.prompt, r.cache_hint) for r in pending[: loop.free]]
        # bounded-dispatch contract: slot admission runs the joiners'
        # chunked prefill — token-scaled budget like a one-shot dispatch
        ticket = self._wd_begin("slot_admit", [r for r, _p, _h in items])
        try:
            admissions, rejected = self._collect(len(items), lambda: loop.admit(items))
        finally:
            self._wd_end(ticket)
        if self._stale_thread():
            # the watchdog declared this admit hung, requeued every pending
            # request, and replaced this thread: the late admissions belong
            # to a torn-down loop
            return []
        admitted_ids = {id(a.key) for a in admissions}
        rejected_ids = {id(k) for k in rejected}
        for adm in admissions:
            r: ServeRequest = adm.key
            r.inflight_admission = adm  # read back at harvest
        if admissions:
            prefill_s = admissions[0].prefill_end - admissions[0].admitted_at
            self.metrics.observe_batch(len(admissions), prefill_s)
            if self.recorder is not None:
                # guarded, not _fr: the riders list must not be built on
                # the recorder-less hot path (the all-off arm's contract)
                self.recorder.record(
                    "dispatch", rid=admissions[0].key.trace_id,
                    occupancy=len(admissions), slot_admit=True,
                    rids=[a.key.trace_id for a in admissions[1:]])
            if was_running:
                self.metrics.observe_refill(len(admissions))
        if rejected:
            # prompts beyond the loop's S bucket: classic batch dispatch
            # between segments (residents wait one blocking generate —
            # bounded by the oversized request itself, and the one-shot
            # program stays the path of record for it)
            fallback = [r for r in pending if id(r) in rejected_ids]
            logger.info(
                "dispatching %d oversized request(s) via the one-shot path",
                len(fallback),
            )
            self._run_batch(fallback)
        return [
            r for r in pending
            if id(r) not in admitted_ids and id(r) not in rejected_ids
        ]

    def _collect(self, occupancy: int, call):
        """Run ``call`` (an admit or a step) with a BatchTrace installed as
        the engine's emit() collector, so the slot loop's ``prefill`` and
        ``decode_seg`` spans land on a batch track of /debug/trace. With
        tracing off (no hub) it is the bare call."""
        if self.obs is None:
            return call()
        bt = self.obs.start_batch(occupancy)
        token = set_collector(bt)
        try:
            return call()
        finally:
            reset_collector(token)
            self.obs.finish_batch(bt)

    # -- segment + harvest --------------------------------------------------

    def _run_segment(self, loop) -> None:
        # bounded-dispatch contract: one decode segment is bounded work
        # whatever the residents' prompts cost — flat segment budget.
        # Deliberately rider-free: segments are the per-token-scale hot
        # path, and recovery re-reads loop.outstanding() itself — a tuple
        # of trace ids per segment would be allocation for a report field
        ticket = None
        if self.watchdog is not None:
            # N-scaled: a fused dispatch holds the host for up to N
            # segments of legitimate work — budget accordingly, so fusing
            # never manufactures a false HUNG (and a real hang still trips
            # after N segment budgets)
            ticket = self.watchdog.begin_dispatch(
                "scheduler", "slot_segment",
                self.watchdog.segment_budget(self.fused_segments),
            )
        try:
            res = self._collect(loop.active, loop.step)
        finally:
            self._wd_end(ticket)
        if self._stale_thread():
            # hung segment: the watchdog already evicted + requeued every
            # RESIDENT and replaced this thread — but rows that finished in
            # this very segment left the slots before the eviction saw
            # them, so their futures are nobody else's to resolve: hand
            # them back (recompute is byte-identical; a rider recovery DID
            # resolve is a done-guarded no-op)
            self._requeue_stale([c.key for c in res.completions])
            return
        self.metrics.observe_segment(
            res.live, res.seconds, res.new_tokens,
            device_segments=getattr(res, "device_segments", 1),
        )
        now = time.monotonic()
        self._emit_stream_deltas(loop)
        for c in res.completions:
            r: ServeRequest = c.key
            adm = getattr(r, "inflight_admission", None)
            t_admit = adm.admitted_at if adm is not None else now
            engine_s = now - t_admit
            rec = ServeRequestRecord(
                request_id=r.request_id,
                status="ok",
                trace_id=r.trace_id,
                queue_wait_s=max(t_admit - r.enqueued_at, 0.0),
                engine_s=engine_s,
                total_s=max(now - r.enqueued_at, 0.0),
                # TTFT anchored at the JOINER's own prefill end — the whole
                # point of refill: first-token time no longer includes
                # strangers' decode
                ttft_s=max(
                    (adm.prefill_end if adm is not None else now)
                    - r.enqueued_at, 0.0,
                ),
                ttft_anchored=adm is not None,
                batch_size=adm.occupancy if adm is not None else res.live,
                prompt_tokens=r.est_tokens,
                generated_tokens=c.gen_tokens,
            )
            rec.cached_prompt_tokens = (
                adm.cached_tokens if adm is not None else 0
            )
            self.metrics.observe_request(rec)
            self._fr("complete", rid=r.trace_id, gen_tokens=c.gen_tokens)
            self._trace_request(r, t_admit, engine_s, None, "ok")
            self._release_preempt_pins(r)
            if r.stream is not None:
                # final harvest text through the same delta path: whatever
                # the per-segment snapshots didn't emit leaves here, so
                # concatenated deltas == the completion text, BEFORE the
                # future resolves (the handler drains after done)
                r.stream.push_text(c.text)
            if not r.future.done():
                r.future.set_result(_Completion(c.text, rec))

    def _emit_stream_deltas(self, loop) -> None:
        """Per-segment streaming harvest: fetch the decoded-so-far text of
        every STREAMING resident (one host fetch per segment, only when
        streaming requests are actually resident) and push the suffix
        deltas into their channels."""
        streams = [
            r for r in loop.outstanding()
            if getattr(r, "stream", None) is not None
        ]
        if not streams:
            return
        partials = loop.partial_outputs(streams)  # keyed by id(request)
        for r in streams:
            text = partials.get(id(r))
            if text:
                r.stream.push_text(text)
