"""Online serving layer over the port's engine.

Counterpart of ``vnsum_tpu/serve`` for one card: the same modules under the
same paths, over ``TorchBackend`` (or the fake and Ollama backends).

- queue.py      bounded request queue: per-request deadlines, typed
                429-style admission control (queue depth + token budget);
                requests carry their end-to-end trace_id and RequestTrace
                across the thread handoff
- scheduler.py  micro-batching scheduler thread that coalesces queued
                requests into shared engine batches (max-wait/max-batch
                policy), plus the QueuedBackend adapter that lets the
                strategies submit their rounds through the queue; installs
                the obs BatchTrace collector around each engine dispatch
                and derives per-request TTFT from its prefill end
- inflight.py   in-flight batching: slot-feeding scheduler over the
                backend's persistent decode loop (start_slot_loop) —
                finished rows are harvested and freed slots refilled from
                the queue at every segment boundary, TTFT anchored at each
                joiner's own prefill
- journal.py    durability: write-ahead request journal (CRC-checked JSONL
                segments, group-commit fsync, compaction on reopen); every
                accepted request is journaled before engine work, outcomes
                append COMPLETE/FAILED/CANCELLED, and restart replays the
                unfinished remainder byte-identically (--journal-dir); the
                record format is the JAX package's byte for byte
- supervisor.py engine supervision: failure classification (transient /
                resource-exhausted / poison / fatal / hung), bounded
                jittered retry, batch bisection that quarantines poison
                requests, and the graceful-degradation ladder
- gang.py       structured jobs: fan-out groups admitted in one pass,
                their membership journaled once per round (GANG records)
- stream.py     per-request SSE emit channel (bounded, coalescing,
                Last-Event-ID resumes); cancellation rides the schedulers
                (DELETE /v1/requests/<id> + the disconnect sweep)
- qos.py        multi-tenant QoS: tenant specs (--tenants), token-bucket
                rate quotas (typed 429 QUOTA + refill-derived Retry-After),
                and the deficit-round-robin weighted-fair pick the queue's
                take paths schedule with — interactive tier first, batch
                tier preemptible in in-flight mode
- metrics.py    counters, rolling gauges and fixed-bucket histograms in
                Prometheus text, plus rolling windows (obs/window.py)
                feeding the SLO engine and the per-tenant ledger
- slo.py        declarative SLOs over the rolling windows (--slo):
                latency-quantile / error-rate / availability objectives,
                fast+slow burn rates, edge-triggered breaches that fire
                the flight recorder; /debug/slo + vnsum_serve_slo_* gauges
- usage.py      per-tenant usage ledger behind the capped label registry
- watchdog.py   liveness: heartbeats, the bounded-dispatch contract, stall
                classification and wedged-dispatch recovery
- server.py     stdlib HTTP front-end
                (python -m vnsum_tpu_torch.serve.server)
- worker.py     the replica fleet's engine-worker process: the server under
                a name, spawned, probed, drained and restarted by a
                WorkerHandle (python -m vnsum_tpu_torch.serve.worker)
- router.py     the fleet's front door: admission, per-tenant accounting
                and a global journal, rendezvous routing on cache_hint or
                tenant over N workers, probe-loop mark-down, journal-
                handoff failover and rolling restarts
                (python -m vnsum_tpu_torch.serve.router; workers run
                --backend torch unless the caller names another)
- federation.py the router's scrape loop over the workers' snapshots:
                fleet rollups, SLO and usage views, the stitched trace,
                and correlated incident bundles

Not ported yet: the serving mesh (ROADMAP A10); ``ServeState`` and the CLI
refuse it by name. As in the JAX package, the fleet's classes are imported
from their modules, not from this package.

ONE scheduler thread owns all backend.generate calls (the engine's CUDA
graphs, prefix cache and stats are not thread-safe), and concurrency lives
entirely in front of it.
"""
from .queue import (
    RequestCancelled,
    RequestQueue,
    RequestShed,
    ServeRequest,
    ShedReason,
)
from .scheduler import MicroBatchScheduler, QueuedBackend
from .inflight import InflightScheduler
from .journal import JournalEntry, RequestJournal
from .metrics import ServeMetrics
from .qos import TenantSpec, TenantTable, TokenBucket, parse_tenant_specs
from .slo import Objective, SloEngine, parse_slo_spec
from .stream import StreamChannel, StreamDetached, StreamRegistry
from .usage import TenantLabelRegistry, UsageLedger
from .watchdog import WATCHDOG_EXIT_CODE, Watchdog, snapshot_stacks
from .supervisor import (
    EngineSupervisor,
    FailureClass,
    FatalEngineError,
    RequestFailed,
    RetryPolicy,
    Rung,
)

__all__ = [
    "EngineSupervisor",
    "FailureClass",
    "FatalEngineError",
    "InflightScheduler",
    "JournalEntry",
    "MicroBatchScheduler",
    "Objective",
    "QueuedBackend",
    "RequestCancelled",
    "RequestFailed",
    "RequestJournal",
    "RequestQueue",
    "RequestShed",
    "RetryPolicy",
    "Rung",
    "ServeMetrics",
    "ServeRequest",
    "ShedReason",
    "SloEngine",
    "StreamChannel",
    "StreamDetached",
    "StreamRegistry",
    "TenantLabelRegistry",
    "TenantSpec",
    "TenantTable",
    "TokenBucket",
    "UsageLedger",
    "WATCHDOG_EXIT_CODE",
    "Watchdog",
    "parse_slo_spec",
    "parse_tenant_specs",
    "snapshot_stacks",
]
