"""Unified observability: request tracing, engine telemetry, histograms,
and Perfetto-loadable timelines — stdlib-only, near-zero-cost when off.

Copy of ``vnsum_tpu/obs``: the serving layer's request traces, the
engine's phase spans, histograms and rolling windows, the flight recorder
and the Chrome trace export.

Six pieces, one span model:

- :mod:`trace`     — `RequestTrace` (request id carried across the HTTP ->
                     queue -> scheduler -> engine thread handoffs),
                     `BatchTrace` (per-engine-batch step telemetry), the
                     contextvar `emit()` hook backends publish through, and
                     the bounded `ObsHub` ring with request sampling
- :mod:`histogram` — fixed-bucket Prometheus histograms with
                     bucket-derived percentiles (p50/p95/p99 in bench JSON)
- :mod:`telemetry` — rolling-window ratios for "now" gauges (rolling
                     spec acceptance, rolling tokens/s)
- :mod:`window`    — ring-of-sub-windows histograms/counters: "last
                     minute" quantiles and counts with the cumulative
                     histogram's observe cost — the SLO engine's
                     (`serve/slo.py`) and usage ledger's substrate
- :mod:`recorder`  — the flight recorder: a bounded ring of typed
                     lifecycle events, dumped atomically on anomalies
                     (brownout, fatal, quarantine, SLO fast-burn, drain)
- :mod:`export`    — Chrome trace-event JSON (loads in chrome://tracing and
                     ui.perfetto.dev): one track per request, one per
                     engine batch; `save_chrome_trace` drops the dump next
                     to the torch.profiler device trace from
                     `core.profiling`

Consumers: `serve/metrics.py` (histogram registry + /metrics), the
scheduler (span recording + TTFT), `backend/engine.py` and `backend/fake.py`
(phase emission), `core/profiling.Tracer` (pipeline spans rebased onto the
same `SpanRecorder`), and the `/debug/trace` endpoint (`serve/server.py`).
"""
from .histogram import Histogram
from .recorder import FlightRecorder
from .telemetry import Rolling
from .trace import (
    BatchTrace,
    ObsHub,
    RequestTrace,
    Span,
    SpanRecorder,
    current_collector,
    emit,
    reset_collector,
    set_collector,
)
from .window import WindowedCounter, WindowedHistogram

__all__ = [
    "BatchTrace",
    "FlightRecorder",
    "Histogram",
    "ObsHub",
    "RequestTrace",
    "Rolling",
    "Span",
    "SpanRecorder",
    "WindowedCounter",
    "WindowedHistogram",
    "current_collector",
    "emit",
    "reset_collector",
    "set_collector",
]
