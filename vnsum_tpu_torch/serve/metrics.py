"""Serving observability: counters, histograms, rolling gauges + Prometheus
text export.

Three consumption surfaces off one locked data structure:

- GET /metrics renders the Prometheus text format — counters/gauges plus
  fixed-bucket histograms (``_bucket``/``_sum``/``_count``) for queue wait,
  TTFT, end-to-end latency, batch occupancy, and accepted-drafts-per-step
  (`obs/histogram.py`);
- snapshot() returns a core.results.ServingStats so run records and the
  serving benchmark embed the same numbers the scrape endpoint reports;
- histograms_snapshot() exposes the bucket state with bucket-derived
  p50/p95/p99, for benches to record instead of bare means.

Metric registry: every exported metric is declared ONCE in the `_reg(...)`
block below — rendering takes its HELP/TYPE text from the registry, and
`metric_names()` lists them (the port's tests hold the list equal to the
JAX package's, less the families of the modules not ported yet: the mesh
(ROADMAP A10), the journal, tenant quotas, SLOs and the fleet (A15b)).

Emission sites for the registry entries: request/shed/batch counters and all
histograms are observed by `serve/scheduler.py` (observe_submit via the
queue's on_admit hook, observe_shed, observe_batch, observe_request);
queue_depth/queued_tokens gauges are read from the live RequestQueue at
scrape time by `serve/server.py`.

Counterpart of ``vnsum_tpu/serve/metrics.py`` without those families.
"""
from __future__ import annotations

from ..analysis.sanitizers import make_lock
from ..core.results import ServeRequestRecord, ServingStats
from ..obs.histogram import (
    ACCEPT_BUCKETS,
    E2E_BUCKETS_S,
    Histogram,
    OCCUPANCY_BUCKETS,
    SCRAPE_BUCKETS_S,
    TTFT_BUCKETS_S,
    WAIT_BUCKETS_S,
)
from ..obs.telemetry import Rolling
from ..obs.window import WindowedHistogram
from .queue import ShedReason
from .usage import TenantLabelRegistry, UsageLedger

_PREFIX = "vnsum_serve_"
_METRICS: dict[str, tuple[str, str]] = {}  # short name -> (type, help)


def _reg(name: str, typ: str, help_: str) -> str:
    _METRICS[name] = (typ, help_)
    return name


# -- the ONE metric registry (names literal for the CI doc lint) -------------
_reg("requests_total", "counter", "requests admitted to the queue")
_reg("requests_completed_total", "counter", "requests answered")
_reg("requests_errored_total", "counter", "requests failed in the engine")
_reg("requests_shed_total", "counter", "requests shed, by reason")
_reg("batches_total", "counter", "engine batches dispatched")
_reg("engine_seconds_total", "counter",
     "wall-clock seconds spent inside backend.generate")
_reg("queue_wait_seconds_total", "counter",
     "total seconds requests spent queued before dispatch")
_reg("prompt_tokens_total", "counter", "prompt tokens admitted")
_reg("generated_tokens_total", "counter", "tokens generated")
_reg("tokens_per_second", "gauge",
     "cumulative (prompt+generated) tokens / engine second")
_reg("tokens_per_second_rolling", "gauge",
     "generated tokens / engine second over the last 256 batches")
_reg("spec_draft_tokens_total", "counter",
     "tokens proposed by the speculative drafter")
_reg("spec_accepted_tokens_total", "counter",
     "drafted tokens the model accepted at verification")
_reg("spec_acceptance_rate", "gauge",
     "cumulative accepted / drafted tokens (0 when spec is off)")
_reg("spec_acceptance_rolling", "gauge",
     "accepted / drafted tokens over the last 256 requests")
_reg("cache_hit_tokens_total", "counter",
     "prompt tokens whose prefill was served from the prefix KV cache")
_reg("cache_hit_rate", "gauge",
     "cumulative cache-hit tokens / prompt tokens (0 when the cache is off)")
_reg("cache_evictions_total", "counter",
     "prefix-cache blocks evicted (LRU under the block budget)")
_reg("cache_blocks_used", "gauge",
     "prefix-cache blocks currently allocated")
_reg("cache_blocks_total", "gauge", "prefix-cache block budget")
_reg("inflight_segments_total", "counter",
     "decode segments dispatched by the in-flight slot loop")
_reg("inflight_refills_total", "counter",
     "requests admitted into a running decode batch at a segment boundary")
_reg("inflight_fused_dispatches_total", "counter",
     "fused slot-loop dispatches by the in-flight scheduler (each covers "
     "up to --fused-segments on-device decode segments; equals "
     "inflight_segments_total at N=1)")
_reg("inflight_fused_segments", "histogram",
     "on-device decode segments retired per fused slot-loop dispatch "
     "(the on-device all-rows-done stop reports fewer than the "
     "configured N on early exit)")
_reg("slots_total", "gauge",
     "decode slots of the in-flight loop (scrape-time; in-flight mode only)")
_reg("slots_busy", "gauge",
     "decode slots occupied at scrape (in-flight mode only)")
_reg("fault_failures_total", "counter",
     "classified engine dispatch failures, by failure class")
_reg("fault_retries_total", "counter",
     "request retries scheduled by the supervisor")
_reg("fault_bisects_total", "counter",
     "batch bisection splits performed to quarantine a poison request")
_reg("fault_quarantined_total", "counter",
     "requests failed with RequestFailed(poison) after bisection")
_reg("fault_backoff_seconds_total", "counter",
     "total seconds the supervisor spent in retry backoff")
_reg("degraded_rung", "gauge",
     "current degradation-ladder rung (0=healthy .. 4=brownout; scrape-time)")
_reg("degraded_steps_total", "counter",
     "degradation-ladder step-downs (resource-failure strikes)")
_reg("degraded_recoveries_total", "counter",
     "degradation-ladder step-ups (recovery probes that passed)")
_reg("qos_preemptions_total", "counter",
     "slot residents evicted mid-decode (watchdog hang recovery)")
_reg("qos_requeues_total", "counter",
     "evicted requests re-admitted through the queue")
# -- structured jobs (serve/gang.py): gang-scheduled fan-out
_reg("gang_admitted_total", "counter",
     "structured jobs (gangs) admitted — one per fan-out request through "
     "the request-level admission gate")
_reg("gang_members_total", "counter",
     "fan-out children recorded into gang groups")
_reg("gang_affinity_picks_total", "counter",
     "take-path batches where the gang-affinity pick co-scheduled two or "
     "more siblings of one gang into the same generation")
_reg("gang_partial_total", "counter",
     "gangs degraded to a partial result (a POISON member was dropped "
     "from the reduce)")
_reg("gang_active", "gauge",
     "live structured-job groups in the gang registry (scrape-time)")
_reg("stream_requests_total", "counter",
     "requests served with SSE streaming (stream=true)")
_reg("stream_events_total", "counter",
     "SSE events written to streaming responses (deltas + progress + done)")
_reg("stream_active", "gauge",
     "streaming responses open right now")
_reg("cancel_requests_total", "counter",
     "requests terminally cancelled, by lifecycle stage at cancel")
_reg("cancel_disconnects_total", "counter",
     "cancellations triggered by client disconnect / idle-consumer timeout "
     "(vs an explicit DELETE)")
_reg("stream_backpressure_coalesced_total", "counter",
     "pending stream events collapsed by the bounded channel's "
     "coalesce-on-full (slow consumer backpressure)")
_reg("stream_resumes_total", "counter",
     "streaming reconnects served via Last-Event-ID (snapshot + continue)")
_reg("stream_heartbeats_total", "counter",
     "SSE keepalive heartbeat comment frames written")
_reg("cache_pinned_blocks", "gauge",
     "prefix-cache blocks pinned by live matches at scrape (leak probe: "
     "returns to 0 when no batch is in flight)")
# -- per-tenant usage ledger (serve/usage.py): labels pass through the
# capped TenantLabelRegistry, so cardinality is bounded by construction
_reg("usage_requests_total", "counter", "requests admitted, by tenant")
_reg("usage_completed_total", "counter", "requests answered ok, by tenant")
_reg("usage_errors_total", "counter", "requests failed, by tenant")
_reg("usage_sheds_total", "counter", "requests shed, by tenant")
_reg("usage_cancels_total", "counter",
     "requests terminally cancelled, by tenant")
_reg("usage_preemptions_total", "counter",
     "slot evictions suffered, by tenant")
_reg("usage_requeues_total", "counter",
     "preempted requests re-admitted, by tenant")
_reg("usage_prompt_tokens_total", "counter", "prompt tokens, by tenant")
_reg("usage_generated_tokens_total", "counter",
     "generated tokens, by tenant")
_reg("usage_cached_tokens_total", "counter",
     "prompt tokens served from the prefix cache (the tenant's cache "
     "savings), by tenant")
_reg("usage_ttft_p99_seconds", "gauge",
     "anchored TTFT p99 over the fast window, by tenant")
_reg("usage_e2e_p99_seconds", "gauge",
     "end-to-end latency p99 over the fast window, by tenant")
_reg("usage_queue_wait_p99_seconds", "gauge",
     "queue-wait p99 over the fast window, by tenant")
_reg("usage_tenants_overflowed", "gauge",
     "distinct tenant names collapsed into the 'other' overflow label by "
     "the capped registry (cardinality pressure probe)")
# -- watchdog (serve/watchdog.py): hang/stall detection + recovery
_reg("watchdog_stalls_total", "counter",
     "stalls declared by the watchdog, by classification (dispatch = a "
     "dispatch past its token-derived budget, lock = a loop thread wedged "
     "outside the engine, helper = a helper thread went quiet)")
_reg("watchdog_recoveries_total", "counter",
     "wedged-dispatch recoveries completed (riders resolved typed HUNG or "
     "requeued, scheduler thread replaced)")
_reg("watchdog_hung_dispatches_total", "counter",
     "engine dispatches declared HUNG (past their wall-clock budget)")
_reg("watchdog_heartbeat_age_seconds", "gauge",
     "seconds since each registered thread's last heartbeat, by thread "
     "(scrape-time; mid-dispatch threads legitimately age until the "
     "dispatch ticket ends)")
# -- flight recorder (obs/recorder.py)
_reg("recorder_events_total", "counter",
     "typed lifecycle events appended to the flight-recorder ring")
_reg("recorder_events_dropped_total", "counter",
     "flight-recorder events evicted by the bounded ring")
_reg("recorder_dumps_total", "counter",
     "anomaly-triggered flight-recorder dumps written")
# -- scrape self-observation (/metrics cost made observable)
_reg("scrape_seconds", "histogram",
     "wall-clock cost of rendering /metrics (state is snapshotted under "
     "the metrics lock, rendered outside it; each scrape reports the "
     "distribution up to and including the PREVIOUS one)")
_reg("queue_depth", "gauge", "requests currently queued")
_reg("queued_tokens", "gauge",
     "billable (uncached) prompt-token estimate currently queued")
_reg("queue_wait_seconds", "histogram",
     "queue wait (submit -> engine dispatch)")
_reg("ttft_seconds", "histogram",
     "time to first token (submit -> end of the batch's prefill phase); "
     "observed only for requests whose batch emitted a prefill anchor, so "
     "counts can trail e2e_seconds when tracing is off")
_reg("e2e_seconds", "histogram",
     "end-to-end request latency (submit -> completion)")
_reg("batch_occupancy", "histogram", "engine batch occupancy at dispatch")
_reg("slot_occupancy", "histogram",
     "busy slots per in-flight decode segment")
_reg("spec_accepted_per_step", "histogram",
     "accepted draft tokens per verify step, per request")


def metric_names(full: bool = True) -> list[str]:
    """Registered metric names (prefixed by default) — the doc-lint surface."""
    return [(_PREFIX + n if full else n) for n in _METRICS]


class ServeMetrics:
    """Aggregate counters + histograms; observe_* methods are called from the
    scheduler thread and the HTTP handler threads, so everything locks.

    Histograms and rolling windows are always on — a handful of integer adds
    per REQUEST (never per token), which is why they need no sampling gate;
    the pricier per-span tracing lives in obs.ObsHub behind --trace-sample.
    """

    def __init__(self, horizon_s: float = 600.0, sub_windows: int = 60,
                 clock=None) -> None:
        import time as _time

        # lock-order-sanitizer hook: plain threading.Lock in production
        self._lock = make_lock("serve.metrics")
        self._clock = clock or _time.monotonic
        self._stats = ServingStats()            # guarded by: _lock
        self._hists = {                         # guarded by: _lock
            "queue_wait_seconds": Histogram(WAIT_BUCKETS_S),
            "ttft_seconds": Histogram(TTFT_BUCKETS_S),
            "e2e_seconds": Histogram(E2E_BUCKETS_S),
            "batch_occupancy": Histogram(OCCUPANCY_BUCKETS),
            "slot_occupancy": Histogram(OCCUPANCY_BUCKETS),
            "inflight_fused_segments": Histogram(OCCUPANCY_BUCKETS),
            "spec_accepted_per_step": Histogram(ACCEPT_BUCKETS),
        }
        self._rolling_accept = Rolling(256)     # guarded by: _lock
        self._rolling_tps = Rolling(256)        # guarded by: _lock
        # the capped label funnel every tenant-labeled series routes
        # through (one tenant, "default", until tenants are ported)
        self.tenant_labels = TenantLabelRegistry()
        # rolling windows (obs/window.py): the exemplar source of the
        # latency buckets and the usage ledger's substrate
        kw = dict(horizon_s=horizon_s, sub_windows=sub_windows,
                  clock=self._clock)
        self._win = {                           # guarded by: _lock
            "queue_wait_seconds": WindowedHistogram(WAIT_BUCKETS_S, **kw),
            "ttft_seconds": WindowedHistogram(TTFT_BUCKETS_S, **kw),
            "e2e_seconds": WindowedHistogram(E2E_BUCKETS_S, **kw),
        }
        self.usage = UsageLedger(registry=self.tenant_labels,  # guarded by: _lock
                                 horizon_s=horizon_s, sub_windows=sub_windows,
                                 clock=self._clock)
        # scrape self-observation: each render times itself and observes
        # here AFTER releasing the lock for the render proper, so a scrape
        # reports the distribution up to and including the previous one
        self._scrape_hist = Histogram(SCRAPE_BUCKETS_S)  # guarded by: _lock
        # window the per-tenant latency gauges report over (ServeState
        # aligns it with --slo-fast-s)
        self.usage_window_s = 60.0

    # -- observation hooks ----------------------------------------------

    def observe_submit(self, n: int = 1) -> None:
        with self._lock:
            self._stats.submitted += n
            self.usage.observe_submit("", n)

    def observe_shed(self, reason: ShedReason, n: int = 1) -> None:
        with self._lock:
            key = reason.value
            self._stats.shed[key] = self._stats.shed.get(key, 0) + n
            self.usage.observe_shed("", n)

    def observe_batch(self, occupancy: int, engine_s: float,
                      gen_tokens: int = 0) -> None:
        with self._lock:
            self._stats.batches += 1
            self._stats.batch_occupancy_sum += occupancy
            self._stats.engine_seconds += engine_s
            self._hists["batch_occupancy"].observe(occupancy)
            self._rolling_tps.add(gen_tokens, engine_s)

    def observe_segment(self, live: int, seg_s: float,
                        gen_tokens: int = 0,
                        device_segments: int = 1) -> None:
        """One in-flight decode dispatch: slot occupancy, engine residency,
        and the tokens it retired (feeds the rolling tokens/s gauge the way
        observe_batch does for batch dispatches). ``device_segments`` is
        how many on-device segment boundaries the dispatch covered —
        segments_total counts those (device cadence) while
        fused_dispatches counts host round trips, so the two series
        diverge exactly by the fusing win."""
        with self._lock:
            n = max(int(device_segments), 1)
            self._stats.segments += n
            self._stats.fused_dispatches += 1
            self._stats.engine_seconds += seg_s
            self._hists["slot_occupancy"].observe(live)
            self._hists["inflight_fused_segments"].observe(n)
            self._rolling_tps.add(gen_tokens, seg_s)

    def observe_refill(self, n: int = 1) -> None:
        """Requests admitted into a RUNNING decode batch at a boundary."""
        with self._lock:
            self._stats.refills += n

    # -- fault-tolerance hooks (serve/supervisor.py consumers) -----------

    def observe_failure(self, failure_class: str) -> None:
        """One classified engine dispatch failure (pre-recovery: a retried
        batch counts here once per failed attempt, while requests_errored
        counts only terminal per-request outcomes)."""
        with self._lock:
            f = self._stats.failures
            f[failure_class] = f.get(failure_class, 0) + 1

    def observe_retry(self, n: int = 1) -> None:
        with self._lock:
            self._stats.retries += n

    def observe_bisect(self) -> None:
        with self._lock:
            self._stats.bisects += 1

    def observe_quarantine(self, n: int = 1) -> None:
        with self._lock:
            self._stats.quarantined += n

    def observe_backoff(self, seconds: float) -> None:
        with self._lock:
            self._stats.backoff_seconds += seconds

    # -- eviction / streaming hooks (serve/inflight.py + serve/stream.py) --

    def observe_preemption(self, n: int = 1) -> None:
        with self._lock:
            self._stats.preemptions += n
            self.usage.observe_preemption("", n)

    def observe_requeue(self, n: int = 1) -> None:
        with self._lock:
            self._stats.requeues += n
            self.usage.observe_requeue("", n)

    # -- structured jobs (serve/gang.py) ----------------------------------

    def observe_gang_admitted(self, n: int = 1) -> None:
        with self._lock:
            self._stats.gang_admitted += n

    def observe_gang_members(self, n: int = 1) -> None:
        with self._lock:
            self._stats.gang_members += n

    def observe_gang_affinity_pick(self, n: int = 1) -> None:
        """One take-path batch in which the affinity pick co-scheduled >=2
        siblings of a gang (counted once per gang per batch)."""
        with self._lock:
            self._stats.gang_affinity_picks += n

    def observe_gang_partial(self, n: int = 1) -> None:
        with self._lock:
            self._stats.gang_partials += n

    def observe_stream_request(self, n: int = 1) -> None:
        with self._lock:
            self._stats.stream_requests += n

    def observe_stream_events(self, n: int = 1) -> None:
        with self._lock:
            self._stats.stream_events += n

    def observe_stream_open(self, delta: int) -> None:
        """+1 when an SSE response opens, -1 when it closes — the
        streams_open gauge."""
        with self._lock:
            self._stats.streams_open = max(
                self._stats.streams_open + delta, 0
            )

    # -- cancellation / stream-hardening hooks ----------------------------

    def observe_cancel(self, stage: str, n: int = 1) -> None:
        """One terminal cancellation, keyed by the lifecycle stage it
        landed in: queued (never dispatched), dispatched (one-shot batch in
        the engine), resident (evicted from a decode slot)."""
        with self._lock:
            c = self._stats.cancelled
            c[stage] = c.get(stage, 0) + n
            self.usage.observe_cancel("", n)

    def observe_cancel_disconnect(self, n: int = 1) -> None:
        with self._lock:
            self._stats.cancel_disconnects += n

    def observe_stream_coalesced(self, n: int = 1) -> None:
        """Pending events collapsed by a bounded StreamChannel hitting its
        maxsize — the backpressure signal a wedged consumer emits."""
        with self._lock:
            self._stats.stream_coalesced += n

    def observe_stream_resume(self, n: int = 1) -> None:
        with self._lock:
            self._stats.stream_resumes += n

    def observe_stream_heartbeat(self, n: int = 1) -> None:
        with self._lock:
            self._stats.stream_heartbeats += n

    def observe_degraded(self, down: bool) -> None:
        """One ladder transition: down=True is a step-down (strike
        threshold), False a recovery step-up."""
        with self._lock:
            if down:
                self._stats.degraded_steps += 1
            else:
                self._stats.degraded_recoveries += 1

    def observe_request(self, rec: ServeRequestRecord) -> None:
        with self._lock:
            if rec.status == "ok":
                self._stats.completed += 1
            elif rec.status == "error":
                self._stats.errors += 1
            self._stats.queue_wait_seconds += rec.queue_wait_s
            self._stats.prompt_tokens += rec.prompt_tokens
            self._stats.generated_tokens += rec.generated_tokens
            self._stats.draft_tokens += rec.draft_tokens
            self._stats.accepted_tokens += rec.accepted_tokens
            self._stats.cache_hit_tokens += rec.cached_prompt_tokens
            self._hists["queue_wait_seconds"].observe(rec.queue_wait_s)
            if rec.status == "ok":
                # only anchored TTFT (a real prefill-end timestamp from the
                # batch trace) enters the histogram: the unanchored fallback
                # equals e2e and would silently poison the quantiles
                if rec.ttft_anchored:
                    self._hists["ttft_seconds"].observe(rec.ttft_s)
                self._hists["e2e_seconds"].observe(rec.total_s)
            if rec.draft_tokens:
                self._rolling_accept.add(rec.accepted_tokens, rec.draft_tokens)
            if rec.spec_steps:
                self._hists["spec_accepted_per_step"].observe(
                    rec.accepted_tokens / rec.spec_steps
                )
            # rolling windows + usage ledger: same honesty rules as the
            # cumulative histograms, plus the trace_id as the per-bucket
            # exemplar so a bad windowed p99 links straight to /debug/trace
            self._win["queue_wait_seconds"].observe(
                rec.queue_wait_s, exemplar=rec.trace_id
            )
            if rec.status == "ok":
                if rec.ttft_anchored:
                    self._win["ttft_seconds"].observe(
                        rec.ttft_s, exemplar=rec.trace_id
                    )
                self._win["e2e_seconds"].observe(
                    rec.total_s, exemplar=rec.trace_id
                )
            self.usage.observe_request("", rec)

    # -- export ----------------------------------------------------------

    def snapshot(self) -> ServingStats:
        import copy

        with self._lock:
            return copy.deepcopy(self._stats)

    def histograms_snapshot(self) -> dict:
        """{name: {buckets, sum, count, p50, p95, p99}} for bench JSON."""
        with self._lock:
            return {k: h.to_dict() for k, h in self._hists.items()}

    def federation_snapshot(self) -> dict:
        """The scrape payload for the fleet router's federation loop
        (``GET /debug/obs/snapshot``): the counters it sums and the raw
        histogram state it merges, snapshotted in ONE lock hold so a
        rollup never ships a count that disagrees with its buckets. Raw
        ``state_dict`` (bounds + counts), not the render format — the
        router folds with Histogram.merge_from."""
        with self._lock:
            s = self._stats
            return {
                "counters": {
                    "requests_total": s.submitted,
                    "requests_completed_total": s.completed,
                    "requests_errored_total": s.errors,
                    "generated_tokens_total": s.generated_tokens,
                },
                "hists": {
                    "e2e_seconds": self._hists["e2e_seconds"].state_dict(),
                    "ttft_seconds": self._hists["ttft_seconds"].state_dict(),
                },
            }

    def usage_snapshot(self, window_s: float | None = None) -> dict:
        """Per-tenant ledger for ``GET /v1/usage``. Latency quantiles cover
        ``window_s`` (default: the whole horizon)."""
        with self._lock:
            return self.usage.snapshot(window_s)

    def render_prometheus(self, queue_depth: int | None = None,
                          queued_tokens: int | None = None,
                          cache_stats: dict | None = None,
                          slot_state: tuple[int, int] | None = None,
                          degraded_rung: int | None = None,
                          gang_state: dict | None = None,
                          recorder_stats: dict | None = None,
                          watchdog_stats: dict | None = None,
                          exemplars: bool = False) -> str:
        """``cache_stats`` is the backend's prefix_cache_stats() snapshot
        (evictions / blocks_used / blocks_total), read at scrape time like
        the queue gauges — the serving layer never mirrors pool state.
        ``recorder_stats`` is the FlightRecorder's stats_dict (absent
        without a recorder).
        ``exemplars=True`` suffixes the latency buckets with OpenMetrics
        exemplars — callers must only set it for scrapes that NEGOTIATED
        the OpenMetrics format (the classic text-format parser rejects a
        trailing ``# {...}`` after a sample and drops the whole scrape).

        Scrape discipline (the /metrics cost): ALL owned state is
        snapshotted in ONE lock hold, the text renders outside it, and the
        render's own wall clock lands in the scrape_seconds histogram — so
        an expensive scrape shows up in the very surface it serves and can
        never stall the observe hot paths for its render phase."""
        import copy

        t_scrape = self._clock()
        # one lock acquisition for stats AND histograms: a scrape must not
        # see a histogram count that disagrees with the counters it shipped
        # with
        with self._lock:
            s = copy.deepcopy(self._stats)
            hists = {k: h.copy() for k, h in self._hists.items()}
            rolling_accept = self._rolling_accept.rate()
            rolling_tps = self._rolling_tps.rate()
            scrape_hist = self._scrape_hist.copy()
            # recent-window exemplars ride the CUMULATIVE latency buckets:
            # recent trace ids are the useful breadcrumbs, and the windowed
            # structures are where they live
            bucket_exemplars = (
                {k: self._win[k].exemplars()
                 for k in ("ttft_seconds", "e2e_seconds")}
                if exemplars else {}
            )
            usage_rows = self.usage.snapshot(self.usage_window_s)
            labels_overflowed = self.tenant_labels.overflowed
        lines = []

        def simple(name, value):
            typ, help_ = _METRICS[name]  # KeyError = unregistered metric
            lines.append(f"# HELP {_PREFIX}{name} {help_}")
            lines.append(f"# TYPE {_PREFIX}{name} {typ}")
            lines.append(f"{_PREFIX}{name} {value}")

        simple("requests_total", s.submitted)
        simple("requests_completed_total", s.completed)
        simple("requests_errored_total", s.errors)
        typ, help_ = _METRICS["requests_shed_total"]
        lines.append(f"# HELP {_PREFIX}requests_shed_total {help_}")
        lines.append(f"# TYPE {_PREFIX}requests_shed_total {typ}")
        for reason in ShedReason:
            lines.append(
                f'{_PREFIX}requests_shed_total{{reason="{reason.value}"}} '
                f"{s.shed.get(reason.value, 0)}"
            )
        simple("batches_total", s.batches)
        # NOTE batch_occupancy_sum is deliberately NOT a standalone series:
        # the batch_occupancy histogram's _sum sample carries the identical
        # number, and the duplicate sample name made Prometheus (and the
        # strict OpenMetrics parser) reject the whole scrape
        simple("engine_seconds_total", round(s.engine_seconds, 6))
        simple("queue_wait_seconds_total", round(s.queue_wait_seconds, 6))
        simple("prompt_tokens_total", s.prompt_tokens)
        simple("generated_tokens_total", s.generated_tokens)
        simple("tokens_per_second", round(s.tokens_per_second, 3))
        simple("tokens_per_second_rolling", round(rolling_tps, 3))
        simple("spec_draft_tokens_total", s.draft_tokens)
        simple("spec_accepted_tokens_total", s.accepted_tokens)
        simple("spec_acceptance_rate", round(s.acceptance_rate, 6))
        simple("spec_acceptance_rolling", round(rolling_accept, 6))
        simple("cache_hit_tokens_total", s.cache_hit_tokens)
        simple("cache_hit_rate", round(s.cache_hit_rate, 6))
        simple("inflight_segments_total", s.segments)
        simple("inflight_refills_total", s.refills)
        simple("inflight_fused_dispatches_total", s.fused_dispatches)
        typ, help_ = _METRICS["fault_failures_total"]
        lines.append(f"# HELP {_PREFIX}fault_failures_total {help_}")
        lines.append(f"# TYPE {_PREFIX}fault_failures_total {typ}")
        # stable label set: every failure class renders, zeros included, so
        # dashboards see series before the first failure of a class
        from .supervisor import FailureClass

        for cls in FailureClass:
            lines.append(
                f'{_PREFIX}fault_failures_total{{class="{cls.value}"}} '
                f"{s.failures.get(cls.value, 0)}"
            )
        simple("fault_retries_total", s.retries)
        simple("fault_bisects_total", s.bisects)
        simple("fault_quarantined_total", s.quarantined)
        simple("fault_backoff_seconds_total", round(s.backoff_seconds, 6))
        simple("degraded_steps_total", s.degraded_steps)
        simple("degraded_recoveries_total", s.degraded_recoveries)
        simple("qos_preemptions_total", s.preemptions)
        simple("qos_requeues_total", s.requeues)
        simple("gang_admitted_total", s.gang_admitted)
        simple("gang_members_total", s.gang_members)
        simple("gang_affinity_picks_total", s.gang_affinity_picks)
        simple("gang_partial_total", s.gang_partials)
        if gang_state is not None:
            # read from the live GangRegistry at scrape time, like the
            # queue gauges — the metrics layer never mirrors group state
            simple("gang_active", gang_state.get("active", 0))
        simple("stream_requests_total", s.stream_requests)
        simple("stream_events_total", s.stream_events)
        simple("stream_active", s.streams_open)
        typ, help_ = _METRICS["cancel_requests_total"]
        lines.append(f"# HELP {_PREFIX}cancel_requests_total {help_}")
        lines.append(f"# TYPE {_PREFIX}cancel_requests_total {typ}")
        # stable label set: every lifecycle stage renders, zeros included,
        # so dashboards see series before the first cancel of a stage
        for stage in ("queued", "dispatched", "resident"):
            lines.append(
                f'{_PREFIX}cancel_requests_total{{stage="{stage}"}} '
                f"{s.cancelled.get(stage, 0)}"
            )
        simple("cancel_disconnects_total", s.cancel_disconnects)
        simple("stream_backpressure_coalesced_total", s.stream_coalesced)
        simple("stream_resumes_total", s.stream_resumes)
        simple("stream_heartbeats_total", s.stream_heartbeats)
        headered: set = set()

        def labeled(name, label_val, value):
            # THE tenant-labeled emission path: every dynamic tenant label
            # funnels through the capped registry (the metric-label-
            # cardinality lint pins this), so hostile names collapse into
            # "other" instead of growing the scrape. Header dedup is a set
            # probe, not a scan of the whole exposition — the usage block
            # emits up to 13 series per tenant on the very path the
            # scrape_seconds self-metric is watching
            typ, help_ = _METRICS[name]
            if name not in headered:
                headered.add(name)
                lines.append(f"# HELP {_PREFIX}{name} {help_}")
                lines.append(f"# TYPE {_PREFIX}{name} {typ}")
            lines.append(
                f'{_PREFIX}{name}'
                f'{{tenant="{self.tenant_labels.canonical(label_val, touch=False)}"}} '
                f'{value}'
            )

        # the per-tenant usage ledger (serve/usage.py): keys are already
        # canonical (the ledger itself is registry-keyed), counters are
        # monotone, latency gauges cover the fast window. Family-outer,
        # tenant-inner: OpenMetrics requires one family's samples to be
        # contiguous
        simple("usage_tenants_overflowed", labels_overflowed)
        for family, value_of in (
            ("usage_requests_total", lambda u: u["requests"]),
            ("usage_completed_total", lambda u: u["completed"]),
            ("usage_errors_total", lambda u: u["errors"]),
            ("usage_sheds_total", lambda u: u["sheds"]),
            ("usage_cancels_total", lambda u: u["cancels"]),
            ("usage_preemptions_total", lambda u: u["preemptions"]),
            ("usage_requeues_total", lambda u: u["requeues"]),
            ("usage_prompt_tokens_total", lambda u: u["prompt_tokens"]),
            ("usage_generated_tokens_total",
             lambda u: u["generated_tokens"]),
            ("usage_cached_tokens_total",
             lambda u: u["cached_tokens_saved"]),
            ("usage_ttft_p99_seconds", lambda u: u["ttft"]["p99_s"]),
            ("usage_e2e_p99_seconds", lambda u: u["e2e"]["p99_s"]),
            ("usage_queue_wait_p99_seconds",
             lambda u: u["queue_wait"]["p99_s"]),
        ):
            for tenant in sorted(usage_rows):
                labeled(family, tenant, value_of(usage_rows[tenant]))
        if recorder_stats is not None:
            simple("recorder_events_total", recorder_stats.get("events", 0))
            simple("recorder_events_dropped_total",
                   recorder_stats.get("dropped", 0))
            simple("recorder_dumps_total", recorder_stats.get("dumps", 0))
        if watchdog_stats is not None:
            # read from the live Watchdog at scrape time, like the queue
            # gauges — the metrics layer never mirrors liveness state.
            # Stable stall-kind label set, zeros included, so dashboards
            # see every series before the first (hopefully never) stall
            from .watchdog import STALL_KINDS

            typ, help_ = _METRICS["watchdog_stalls_total"]
            lines.append(f"# HELP {_PREFIX}watchdog_stalls_total {help_}")
            lines.append(f"# TYPE {_PREFIX}watchdog_stalls_total {typ}")
            stalls = watchdog_stats.get("stalls", {})
            for kind in STALL_KINDS:
                lines.append(
                    # lint-allow[metric-label-cardinality]: STALL_KINDS is the watchdog's code-declared classification vocabulary — a fixed 3-entry tuple, never request-derived
                    f'{_PREFIX}watchdog_stalls_total{{kind="{kind}"}} '
                    f"{stalls.get(kind, 0)}"
                )
            simple("watchdog_recoveries_total",
                   watchdog_stats.get("recoveries", 0))
            simple("watchdog_hung_dispatches_total",
                   watchdog_stats.get("hung_dispatches", 0))
            ages = watchdog_stats.get("heartbeat_ages", {})
            if ages:
                typ, help_ = _METRICS["watchdog_heartbeat_age_seconds"]
                lines.append(
                    f"# HELP {_PREFIX}watchdog_heartbeat_age_seconds {help_}"
                )
                lines.append(
                    f"# TYPE {_PREFIX}watchdog_heartbeat_age_seconds {typ}"
                )
                for name in sorted(ages):
                    lines.append(
                        f'{_PREFIX}watchdog_heartbeat_age_seconds'
                        # lint-allow[metric-label-cardinality]: thread labels are registration-time code literals ("scheduler") — a bounded, operator-invisible set, never request-derived
                        f'{{thread="{name}"}} {ages[name]}'
                    )
        if degraded_rung is not None:
            # read from the live supervisor at scrape time, like the queue
            # gauges — the metrics layer never mirrors ladder state
            simple("degraded_rung", degraded_rung)
        if slot_state is not None:
            # (total, busy) read from the live slot loop at scrape time,
            # like the queue gauges — the metrics layer never mirrors it
            simple("slots_total", slot_state[0])
            simple("slots_busy", slot_state[1])
        if cache_stats is not None:
            simple("cache_evictions_total", cache_stats.get("evictions", 0))
            simple("cache_blocks_used", cache_stats.get("blocks_used", 0))
            simple("cache_blocks_total", cache_stats.get("blocks_total", 0))
            if "pinned_blocks" in cache_stats:
                # live-match pin count (radix introspection): the chaos
                # soaks assert this returns to baseline after churn — a
                # non-zero value with no batch in flight is a pin leak
                simple("cache_pinned_blocks", cache_stats["pinned_blocks"])
        if queue_depth is not None:
            simple("queue_depth", queue_depth)
        if queued_tokens is not None:
            simple("queued_tokens", queued_tokens)
        for name, h in hists.items():
            lines.extend(h.render(_PREFIX + name, _METRICS[name][1],
                                  bucket_exemplars.get(name)))
        lines.extend(scrape_hist.render(
            _PREFIX + "scrape_seconds", _METRICS["scrape_seconds"][1]
        ))
        if exemplars:
            # OpenMetrics family naming: a counter family's HELP/TYPE
            # metadata carries the name WITHOUT the _total suffix (samples
            # keep it) — the classic 0.0.4 rendering above uses the full
            # sample name, which a strict OM parser rejects, dropping the
            # whole exposition. Rewrite metadata lines only. Counters whose
            # OM family name cannot be expressed — no _total suffix, or a
            # stripped name that collides with another registered family
            # (queue_wait_seconds_total vs the queue_wait_seconds latency
            # histogram) — are demoted to `unknown`, the OM escape hatch
            # whose sample name equals its family name
            om = []
            for ln in lines:
                if ln.startswith("# "):
                    _hash, _, rest = ln.partition(" ")
                    kind, _, rest = rest.partition(" ")
                    name, _, tail = rest.partition(" ")
                    base = name[len(_PREFIX):]
                    if _METRICS.get(base, ("",))[0] == "counter":
                        stripped = base[: -len("_total")]
                        if base.endswith("_total") and stripped not in _METRICS:
                            name = _PREFIX + stripped
                        elif kind == "TYPE":
                            tail = "unknown"
                        ln = f"# {kind} {name} {tail}"
                om.append(ln)
            lines = om
        out = "\n".join(lines) + "\n"
        # self-observation AFTER the render: the cost just paid lands in
        # the NEXT scrape's scrape_seconds (one short lock hold, no render
        # work inside it)
        with self._lock:
            self._scrape_hist.observe(self._clock() - t_scrape)
        return out
