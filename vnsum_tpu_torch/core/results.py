"""Structured run records.

Copy of ``vnsum_tpu/core/results.py``: the offline pipeline's records and
the serving layer's (``ServeRequestRecord``, ``ServingStats``),
keeping the reference's pipeline_results JSON schema
(run_full_evaluation_pipeline.py:927-947: pipeline_info / config / results
{document_stats, summarization, evaluation}).
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class DocumentRecord:
    """Per-document processing details (ref :575-582).

    `num_chunks` and `llm_calls` are true per-document counts; the
    processing time is the document's even share of its batch's wall clock
    (see ModelRunRecord.time_basis)."""

    filename: str
    num_chunks: int
    processing_time: float
    summary_length_chars: int
    llm_calls: int = 0
    status: str = "success"
    error: str | None = None


@dataclass
class ModelRunRecord:
    """Per-model summarization stats (ref :586-607)."""

    model: str
    approach: str
    total_documents: int = 0
    successful: int = 0
    failed: int = 0
    total_chunks: int = 0
    total_time: float = 0.0
    status: str = "success"
    error: str | None = None
    time_basis: str = "batch_amortized"
    processing_details: list[DocumentRecord] = field(default_factory=list)

    @property
    def avg_processing_time_per_doc(self) -> float:
        return self.total_time / self.total_documents if self.total_documents else 0.0

    @property
    def chunks_per_second(self) -> float:
        return self.total_chunks / self.total_time if self.total_time else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["avg_processing_time_per_doc"] = self.avg_processing_time_per_doc
        d["chunks_per_second"] = self.chunks_per_second
        return d


@dataclass
class ServeRequestRecord:
    """Per-request online-serving observability (serve/scheduler.py).

    One record per request DISPATCHED to the engine — completed or errored.
    Shed requests never reach a batch and are counted per-reason in
    ServingStats.shed instead (their typed RequestShed carries the reason
    to the caller). The serving HTTP layer returns these inline with
    responses and a load generator aggregates
    them, so the same fields serve live debugging and committed benchmark
    evidence.

    ``trace_id`` is the END-TO-END correlation id (vnsum_tpu_torch.obs): the same
    string rides the X-Request-Id response header, the /debug/trace dump's
    request track, and log lines — a summarize request's fanned-out prompts
    all share its trace_id while keeping distinct queue-level request_ids."""

    request_id: int
    status: str = "ok"  # ok | error
    trace_id: str = ""
    queue_wait_s: float = 0.0  # submit -> engine dispatch
    engine_s: float = 0.0      # wall clock of the shared engine batch
    total_s: float = 0.0       # submit -> completion
    # submit -> first token: queue wait + the batch's prefill phase when the
    # backend emitted one (obs.BatchTrace.first_token_at), else the whole
    # engine call — the fused one-shot program has no observable midpoint.
    # ttft_anchored says which: only anchored values feed the
    # vnsum_serve_ttft_seconds histogram (an unanchored fallback is just
    # e2e relabeled and would poison the quantiles)
    ttft_s: float = 0.0
    ttft_anchored: bool = False
    batch_size: int = 0        # occupancy of the engine batch it rode
    prompt_tokens: int = 0
    generated_tokens: int = 0
    # reference-guided speculative decoding (vnsum_tpu_torch.spec): per-request
    # drafting/acceptance, attributed from the backend's take_spec_report
    # hook (all zero when speculation was off for the batch). spec_steps
    # counts the verify forwards the row was live for — accepted/steps feeds
    # the vnsum_serve_spec_accepted_per_step histogram
    draft_tokens: int = 0
    accepted_tokens: int = 0
    spec_steps: int = 0
    # radix prefix KV cache (vnsum_tpu_torch.cache): prompt tokens whose prefill
    # was served from cached prefix blocks, attributed from the backend's
    # take_cache_report hook (0 when the cache is off or the prompt missed)
    cached_prompt_tokens: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / self.draft_tokens if self.draft_tokens else 0.0

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of this request's prompt tokens served from the prefix
        cache."""
        if not self.prompt_tokens:
            return 0.0
        return min(self.cached_prompt_tokens / self.prompt_tokens, 1.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["acceptance_rate"] = round(self.acceptance_rate, 6)
        d["cache_hit_rate"] = round(self.cache_hit_rate, 6)
        return d


@dataclass
class ServingStats:
    """Aggregate serving counters — the snapshot form of serve.ServeMetrics,
    embeddable in run records (PipelineResults.serving) and bench JSON."""

    submitted: int = 0
    completed: int = 0
    errors: int = 0
    shed: dict[str, int] = field(default_factory=dict)  # reason -> count
    batches: int = 0
    batch_occupancy_sum: int = 0
    engine_seconds: float = 0.0
    queue_wait_seconds: float = 0.0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    # speculative decoding aggregates (sums of the per-request fields)
    draft_tokens: int = 0
    accepted_tokens: int = 0
    # prefix KV cache aggregate: prompt tokens served from cached blocks
    cache_hit_tokens: int = 0
    # in-flight batching (serve/inflight.py): decode segments dispatched by
    # the slot loop, and requests admitted into a RUNNING decode batch at a
    # segment boundary (0 for the batch-dispatch scheduler)
    segments: int = 0
    refills: int = 0
    # fused multi-step decode: host dispatches of the slot loop (each
    # covers up to --fused-segments on-device segments; == segments at N=1)
    fused_dispatches: int = 0
    # fault tolerance (serve/supervisor.py): classified dispatch failures,
    # retries scheduled, bisection splits, requests quarantined as poison,
    # total backoff slept, and degradation-ladder transitions
    failures: dict[str, int] = field(default_factory=dict)  # class -> count
    retries: int = 0
    bisects: int = 0
    quarantined: int = 0
    backoff_seconds: float = 0.0
    degraded_steps: int = 0
    degraded_recoveries: int = 0
    # watchdog recovery (serve/inflight.py): slot residents evicted from a
    # hung loop, and their matching requeues
    preemptions: int = 0
    requeues: int = 0
    # SSE streaming (serve/stream.py): streamed requests admitted, SSE
    # events written, and streams open right now (the scrape-time gauge)
    stream_requests: int = 0
    stream_events: int = 0
    streams_open: int = 0
    # request cancellation (serve/scheduler.py cancel paths): terminal
    # cancels by lifecycle stage (queued / dispatched / resident), plus how
    # many were triggered by a client disconnect or idle-consumer timeout
    # rather than an explicit DELETE
    cancelled: dict[str, int] = field(default_factory=dict)  # stage -> count
    cancel_disconnects: int = 0
    # stream hardening (serve/stream.py): pending events collapsed by the
    # bounded channel's coalesce-on-full, Last-Event-ID reattaches served,
    # and keepalive heartbeat frames written
    stream_coalesced: int = 0
    stream_resumes: int = 0
    stream_heartbeats: int = 0
    # structured jobs (serve/gang.py): gangs admitted through the one-pass
    # request-level gate, fan-out children recorded into groups, take-path
    # batches where the affinity pick co-scheduled siblings, and gangs
    # degraded to a partial result
    gang_admitted: int = 0
    gang_members: int = 0
    gang_affinity_picks: int = 0
    gang_partials: int = 0

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / self.draft_tokens if self.draft_tokens else 0.0

    @property
    def cache_hit_rate(self) -> float:
        if not self.prompt_tokens:
            return 0.0
        return min(self.cache_hit_tokens / self.prompt_tokens, 1.0)

    @property
    def avg_batch_occupancy(self) -> float:
        return self.batch_occupancy_sum / self.batches if self.batches else 0.0

    @property
    def tokens_per_second(self) -> float:
        total = self.prompt_tokens + self.generated_tokens
        return total / self.engine_seconds if self.engine_seconds else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shed_total"] = self.shed_total
        d["avg_batch_occupancy"] = self.avg_batch_occupancy
        d["tokens_per_second"] = self.tokens_per_second
        d["acceptance_rate"] = round(self.acceptance_rate, 6)
        d["cache_hit_rate"] = round(self.cache_hit_rate, 6)
        return d


@dataclass
class PipelineResults:
    """Top-level run record, persisted as
    evaluation_results/pipeline_results_<ts>.json (ref :927-947)."""

    config: dict
    start_time: float = field(default_factory=time.time)
    document_stats: dict = field(default_factory=dict)
    summarization: dict[str, Any] = field(default_factory=dict)
    evaluation: dict[str, Any] = field(default_factory=dict)
    engine: dict[str, Any] = field(default_factory=dict)

    def add_summarization(self, record: ModelRunRecord) -> None:
        self.summarization[record.model] = record.to_dict()

    def add_evaluation(self, model: str, metrics: dict) -> None:
        self.evaluation[model] = metrics

    def to_dict(self) -> dict:
        end = time.time()
        return {
            "pipeline_info": {
                "timestamp": time.strftime(
                    "%Y-%m-%dT%H:%M:%S", time.localtime(self.start_time)
                ),
                "duration_seconds": end - self.start_time,
                "approach": self.config.get("approach"),
                "framework": "vnsum_tpu_torch",
            },
            "config": self.config,
            "results": {
                "document_stats": self.document_stats,
                "summarization": self.summarization,
                "evaluation": self.evaluation,
                "engine": self.engine,
            },
        }

    def save(self, results_dir: str | Path) -> Path:
        out = Path(results_dir)
        out.mkdir(parents=True, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = out / f"pipeline_results_{ts}.json"
        n = 1
        while path.exists():
            path = out / f"pipeline_results_{ts}_{n}.json"
            n += 1
        path.write_text(
            json.dumps(self.to_dict(), indent=2, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        return path
