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
- supervisor.py engine supervision: failure classification (transient /
                resource-exhausted / poison / fatal / hung), bounded
                jittered retry, batch bisection that quarantines poison
                requests, and the graceful-degradation ladder
- gang.py       structured jobs: fan-out groups admitted in one pass
- stream.py     per-request SSE emit channel (bounded, coalescing,
                Last-Event-ID resumes); cancellation rides the schedulers
                (DELETE /v1/requests/<id> + the disconnect sweep)
- metrics.py    counters, rolling gauges and fixed-bucket histograms in
                Prometheus text, plus rolling windows (obs/window.py)
- usage.py      usage ledger behind the capped label registry (one
                tenant, "default", until tenants are ported)
- watchdog.py   liveness: heartbeats, the bounded-dispatch contract, stall
                classification and wedged-dispatch recovery
- server.py     stdlib HTTP front-end
                (python -m vnsum_tpu_torch.serve.server)

Not ported yet (ROADMAP A15b): durable serving (journal.py), tenants
(qos.py), SLOs (slo.py), the fleet (router, federation, worker) and the
strategies' streaming rounds. This package carries no hooks for them;
``ServeState`` and the CLI refuse their arguments by name.

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
from .metrics import ServeMetrics
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
    "MicroBatchScheduler",
    "QueuedBackend",
    "RequestCancelled",
    "RequestFailed",
    "RequestQueue",
    "RequestShed",
    "RetryPolicy",
    "Rung",
    "ServeMetrics",
    "ServeRequest",
    "ShedReason",
    "StreamChannel",
    "StreamDetached",
    "StreamRegistry",
    "TenantLabelRegistry",
    "UsageLedger",
    "WATCHDOG_EXIT_CODE",
    "Watchdog",
    "snapshot_stacks",
]
