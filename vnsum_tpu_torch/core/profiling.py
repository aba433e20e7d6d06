"""Tracing / profiling subsystem.

Counterpart of ``vnsum_tpu/core/profiling.py``:

- ``Tracer.span(name)`` — nested wall-clock spans with aggregated
  statistics, thread-safe, over the obs span model
  (``obs/trace.SpanRecorder``); a copy of the JAX module's. The pipeline
  runner keeps one per run, writes its ``to_dict()`` into the results JSON
  (``results.tracing``) and, when ``VNSUM_PROFILE_DIR`` is set, its
  timeline as a Chrome trace (``Tracer.chrome_trace()``).
- ``device_profile(log_dir)`` — the JAX hook wraps ``jax.profiler.trace``;
  here the enclosed block runs under ``torch.profiler`` (CPU activity, plus
  CUDA activity where a card is visible) and the trace lands in the
  directory as a Chrome trace-event JSON, next to the serving layer's own
  host-span dumps, so both open in ui.perfetto.dev. Gated: a no-op unless
  a directory is given or ``VNSUM_PROFILE_DIR`` is set.
- ``annotate(name)`` — a named range in a device trace: JAX's
  ``TraceAnnotation``, here ``torch.profiler.record_function``, so the
  engine's phases (``prefill[B=..,S=..]``, ``decode_seg[...]`` ...) show in
  a ``torch.profiler`` trace around the kernels they launch.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from ..obs.trace import Span, SpanRecorder

_SEQ = itertools.count(1)


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, duration: float) -> None:
        self.count += 1
        self.total_s += duration
        self.min_s = min(self.min_s, duration)
        self.max_s = max(self.max_s, duration)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": self.total_s,
            "mean_s": self.total_s / self.count if self.count else 0.0,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
        }


class Tracer:
    """Aggregating wall-clock tracer over the shared obs span model.

    Span names are hierarchical: nested spans get `parent/child` keys, so the
    run record shows e.g. `summarize/batch` under `summarize`. One Tracer is
    shared per pipeline run; use `reset()` between runs.

    Two views of the same spans: `stats()` aggregates per name (bounded
    state, any run length — what lands in the run record), and `timeline()`
    keeps the first `timeline_maxlen` raw spans for `chrome_trace()` export.
    The recorder's `on_close` hook feeds aggregation, so the two views can
    never disagree about a span's duration.
    """

    def __init__(self, timeline_maxlen: int = 4096) -> None:
        self._stats: dict[str, SpanStats] = {}
        self._lock = threading.Lock()
        self._rec = SpanRecorder(maxlen=timeline_maxlen,
                                 on_close=self._aggregate)

    def _aggregate(self, full_name: str, duration: float) -> None:
        with self._lock:
            self._stats.setdefault(full_name, SpanStats()).add(duration)

    def span(self, name: str):
        return self._rec.span(name)

    def record(self, name: str, duration: float) -> None:
        """Record an externally-timed span (e.g. a device-side step time)."""
        self._aggregate(name, duration)
        self._rec.add(name, time.monotonic() - duration, duration)

    def stats(self) -> dict[str, dict]:
        with self._lock:
            return {k: v.to_dict() for k, v in sorted(self._stats.items())}

    def timeline(self) -> list[Span]:
        """Raw spans in completion order (bounded by timeline_maxlen)."""
        return self._rec.spans()

    def chrome_trace(self, process_name: str = "pipeline") -> dict:
        """Perfetto-loadable Chrome trace-event JSON of the timeline — the
        offline twin of the serving layer's /debug/trace dump."""
        from ..obs.export import spans_to_chrome

        return spans_to_chrome(self.timeline(), process_name)

    def to_dict(self) -> dict:
        return {"spans": self.stats()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
        self._rec.clear()


@contextlib.contextmanager
def device_profile(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block into
    ``<log_dir>/device_<utc-ms>_<n>.json``; returns nothing. ``log_dir``
    falls back to ``$VNSUM_PROFILE_DIR``; when neither is set this is a
    no-op."""
    log_dir = log_dir or os.environ.get("VNSUM_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(out / f"device_{int(time.time() * 1000)}_{next(_SEQ)}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range in a device trace (``torch.profiler.record_function``).
    Costs one RecordFunction when no profiler runs; the engine opens one a
    group, segment or verify step, never one a replayed decode step."""
    from torch.profiler import record_function

    with record_function(name):
        yield
