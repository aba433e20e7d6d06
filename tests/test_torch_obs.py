"""Unit tests for the vnsum_tpu_torch.obs observability subsystem: histogram
bucket math + Prometheus text rendering, Chrome trace-event JSON schema,
ring-buffer eviction, span recording, sampling, rolling windows, the
device-profile hook and core/logging's handler installation (the cases of
tests/test_obs.py, the pipeline Tracer's aside)."""
from __future__ import annotations

import json
import logging
import threading
import time

import pytest

from vnsum_tpu_torch.obs import (
    BatchTrace,
    Histogram,
    ObsHub,
    RequestTrace,
    Rolling,
    SpanRecorder,
    current_collector,
    emit,
    reset_collector,
    set_collector,
)
from vnsum_tpu_torch.obs.export import chrome_trace, spans_to_chrome


# -- histogram bucket math ----------------------------------------------------


def test_histogram_bucket_assignment_and_counts():
    h = Histogram((0.01, 0.1, 1.0))
    for v in (0.005, 0.01, 0.05, 0.5, 2.0):
        h.observe(v)
    # boundaries are inclusive on the upper edge (Prometheus `le`)
    assert h.counts == [2, 1, 1, 1]
    assert h.count == 5
    assert h.sum == pytest.approx(2.565)


def test_histogram_rejects_bad_bounds():
    with pytest.raises(ValueError):
        Histogram(())
    with pytest.raises(ValueError):
        Histogram((1.0, 0.5))


def test_histogram_percentiles_interpolate_within_bucket():
    h = Histogram((1.0, 2.0, 4.0))
    for _ in range(100):
        h.observe(1.5)  # all land in (1, 2]
    # rank 50 of 100 falls midway through the (1,2] bucket
    assert h.percentile(0.50) == pytest.approx(1.5)
    assert h.percentile(0.99) == pytest.approx(1.99)
    # +Inf tail floors at the highest finite bound, like histogram_quantile
    h2 = Histogram((1.0,))
    h2.observe(50.0)
    assert h2.percentile(0.99) == 1.0
    # empty histogram: quantiles are 0, not NaN
    assert Histogram((1.0,)).percentile(0.5) == 0.0


def test_histogram_prometheus_rendering_is_cumulative():
    h = Histogram((0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    lines = h.render("x_seconds", "help text")
    assert lines[0] == "# HELP x_seconds help text"
    assert lines[1] == "# TYPE x_seconds histogram"
    assert 'x_seconds_bucket{le="0.1"} 1' in lines
    assert 'x_seconds_bucket{le="1"} 2' in lines       # cumulative
    assert 'x_seconds_bucket{le="+Inf"} 3' in lines
    assert "x_seconds_sum 5.55" in lines
    assert "x_seconds_count 3" in lines


def test_histogram_to_dict_has_quantiles():
    h = Histogram((1.0, 2.0))
    for v in (0.5, 1.5, 3.0):
        h.observe(v)
    d = h.to_dict()
    assert d["count"] == 3 and d["buckets"]["+Inf"] == 1
    assert set(d) >= {"p50", "p95", "p99", "sum", "count", "buckets"}


def test_histogram_merge_mismatched_ladders_raises_typed():
    from vnsum_tpu_torch.obs.histogram import HistogramMergeError

    a = Histogram((0.1, 1.0))
    b = Histogram((0.1, 1.0, 10.0))
    with pytest.raises(HistogramMergeError) as exc:
        a.merge_from(b)
    # the typed error IS the fleet-federation contract: a ValueError
    # subclass a rollup can catch without masking real bugs
    assert isinstance(exc.value, ValueError)
    assert "different bounds" in str(exc.value)
    # from_state hits the same typed error on a counts/ladder mismatch
    state = a.state_dict()
    state["counts"] = state["counts"][:-1]
    with pytest.raises(HistogramMergeError):
        Histogram.from_state(state)


def test_histogram_merge_equals_observing_union():
    """Property: merging N worker-shaped histograms (state_dict ->
    from_state -> merge_from, the federation round trip) is EXACTLY
    observing the union of their samples — counts vector, sum, count, and
    every derived percentile agree."""
    import random

    rng = random.Random(19)
    bounds = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
    union = Histogram(bounds)
    merged = None
    for _worker in range(5):
        h = Histogram(bounds)
        for _ in range(rng.randrange(0, 40)):
            v = rng.choice([rng.uniform(0.0, 0.6), rng.expovariate(0.5)])
            h.observe(v)
            union.observe(v)
        wire = Histogram.from_state(h.state_dict())  # the scrape hop
        if merged is None:
            merged = wire
        else:
            merged.merge_from(wire)
    assert merged is not None
    assert merged.counts == union.counts
    assert merged.count == union.count
    assert merged.sum == pytest.approx(union.sum)
    for q in (0.5, 0.9, 0.95, 0.99):
        assert merged.percentile(q) == pytest.approx(union.percentile(q))
    assert merged.fraction_le(0.5) == pytest.approx(union.fraction_le(0.5))


# -- rolling window -----------------------------------------------------------


def test_rolling_window_evicts_old_samples():
    r = Rolling(window=2)
    r.add(1, 10)   # 10% acceptance
    assert r.rate() == pytest.approx(0.1)
    r.add(9, 10)
    r.add(10, 10)  # evicts the first sample
    assert r.samples == 2
    assert r.rate() == pytest.approx(19 / 20)
    assert Rolling(4).rate() == 0.0  # empty denominator -> 0, not ZeroDivision


# -- span recorder (the shared Tracer/RequestTrace primitive) -----------------


def test_span_recorder_hierarchical_names_and_bound():
    rec = SpanRecorder(maxlen=3)
    with rec.span("outer"):
        with rec.span("inner"):
            pass
    names = [s.name for s in rec.spans()]
    assert names == ["outer/inner", "outer"]  # closed in completion order
    for i in range(5):
        rec.add(f"extra{i}", 0.0, 0.1)
    assert len(rec.spans()) == 3  # bounded, never unbounded growth


def test_request_trace_tracks_and_finish():
    tr = RequestTrace("req-abc")
    a, b = tr.next_track(), tr.next_track()
    assert (a, b) == (1, 2)
    tr.add("queue_wait", time.monotonic(), 0.01, track=a)
    tr.finish("ok")
    assert tr.status == "ok"
    names = [s.name for s in tr.spans]
    assert "request" in names and "queue_wait" in names


def test_finished_trace_is_sealed_against_late_spans():
    # a shed closes the trace mid-fan-out while sibling prompts are still
    # queued; their eventual completions must not mutate the exported ring
    tr = RequestTrace("req-shed")
    tr.add("queue_wait", time.monotonic(), 0.01, track=1)
    tr.finish("shed:queue_full")
    n = len(tr.spans_snapshot())
    tr.add("engine", time.monotonic(), 0.2, track=2)  # straggler: dropped
    assert len(tr.spans_snapshot()) == n


def test_unsynced_prefill_does_not_anchor_ttft():
    # an engine whose prefill call returns at async DISPATCH (the JAX
    # engine without instrument=True) — its emitted duration bounds submission, not device
    # time, and must not become the TTFT anchor (synced=False); an
    # instrumented (sync-bounded) prefill must
    bt = BatchTrace(batch_id=1, occupancy=2)
    t0 = time.monotonic()
    bt.event("prefill", t0, 0.0005, B=2, synced=False)
    assert bt.first_token_at is None
    bt.event("spec_prefill", t0, 0.3, B=2, synced=True)
    assert bt.first_token_at == pytest.approx(t0 + 0.3)


# -- emit / collector propagation --------------------------------------------


def test_emit_noops_without_collector():
    assert current_collector() is None
    emit("prefill", time.monotonic(), 0.1, B=4)  # must not raise or record


def test_emit_lands_on_installed_collector_and_sets_ttft_anchor():
    bt = BatchTrace(batch_id=1, occupancy=4)
    token = set_collector(bt)
    try:
        t0 = time.monotonic()
        emit("prefill", t0, 0.25, B=4)
        emit("decode", t0 + 0.25, 0.5, B=4)
    finally:
        reset_collector(token)
    assert [e.name for e in bt.events] == ["prefill", "decode"]
    assert bt.first_token_at == pytest.approx(t0 + 0.25)
    assert current_collector() is None
    emit("after", time.monotonic(), 0.1)
    assert len(bt.events) == 2  # nothing lands after reset


# -- hub: sampling + ring eviction -------------------------------------------


def test_hub_ring_evicts_oldest():
    hub = ObsHub(sample=1.0, ring=3)
    for i in range(5):
        hub.finish_request(hub.start_request(f"req-{i}"))
    reqs, _ = hub.snapshot()
    assert [r.trace_id for r in reqs] == ["req-2", "req-3", "req-4"]
    assert hub.dropped_requests == 2
    for i in range(5):
        hub.finish_batch(hub.start_batch(occupancy=i))
    _, batches = hub.snapshot()
    assert len(batches) == 3


def test_hub_sampling_rate_is_exact_deterministically():
    hub = ObsHub(sample=0.25, ring=1000)
    traced = sum(hub.start_request("r") is not None for _ in range(100))
    assert traced == 25  # error-diffusion accumulator: exact, no RNG


def test_hub_sample_zero_never_traces():
    hub = ObsHub(sample=0.0)
    assert all(hub.start_request("r") is None for _ in range(20))


# -- chrome trace export ------------------------------------------------------


def _valid_chrome(doc: dict) -> None:
    """Schema assertions matching what Perfetto's JSON importer requires."""
    json.loads(json.dumps(doc))  # JSON-serializable end to end
    assert isinstance(doc["traceEvents"], list)
    for e in doc["traceEvents"]:
        assert e["ph"] in ("X", "M")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
            assert isinstance(e["name"], str) and e["name"]
        else:
            assert e["name"] in ("process_name", "thread_name")
            assert "name" in e["args"]


def test_chrome_trace_has_request_and_batch_tracks():
    hub = ObsHub(sample=1.0)
    bt = hub.start_batch(occupancy=2)
    bt.event("prefill", time.monotonic(), 0.1, B=2)
    hub.finish_batch(bt, gen_tokens=40)
    tr = hub.start_request("req-xyz")
    track = tr.next_track()
    tr.add("queue_wait", time.monotonic(), 0.01, track=track)
    tr.add("engine", time.monotonic(), 0.2, track=track, batch=bt.batch_id)
    hub.finish_request(tr)

    doc = hub.chrome_trace()
    _valid_chrome(doc)
    procs = {
        e["args"]["name"]
        for e in doc["traceEvents"]
        if e["ph"] == "M" and e["name"] == "process_name"
    }
    assert "engine" in procs                      # >= one batch track
    assert "request req-xyz" in procs             # >= one request track
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {"batch[occ=2]", "prefill", "queue_wait", "engine", "request"} <= {
        e["name"] for e in slices
    }


def test_device_profile_writes_a_chrome_trace(tmp_path):
    """core/profiling.device_profile (the pipeline Tracer is ROADMAP A14):
    the block runs under torch.profiler and one trace-event JSON lands in
    the directory; a second capture never overwrites the first."""
    import torch

    from vnsum_tpu_torch.core.profiling import device_profile

    for _ in range(2):
        with device_profile(str(tmp_path)):
            torch.ones(4) @ torch.ones(4)
    files = sorted(tmp_path.glob("device_*.json"))
    assert len(files) == 2
    doc = json.loads(files[0].read_text())
    assert doc["traceEvents"]


def test_device_profile_is_a_noop_without_a_directory(tmp_path, monkeypatch):
    from vnsum_tpu_torch.core.profiling import device_profile

    monkeypatch.delenv("VNSUM_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_profile():
        pass
    assert list(tmp_path.iterdir()) == []


# -- logging --------------------------------------------------


def _fresh_vnsum_root():
    root = logging.getLogger("vnsum")
    for h in list(root.handlers):
        if getattr(h, "_vnsum_stream_handler", False):
            root.removeHandler(h)
    return root


def test_get_logger_installs_on_vnsum_root_even_when_global_root_configured():
    from vnsum_tpu_torch.core.logging import get_logger

    _fresh_vnsum_root()
    # the old bug: a configured GLOBAL root (pytest/absl/basicConfig) made
    # get_logger skip installation entirely, silencing all vnsum logs
    assert logging.getLogger().handlers, "pytest should have root handlers"
    get_logger("vnsum.test")
    root = logging.getLogger("vnsum")
    marked = [h for h in root.handlers
              if getattr(h, "_vnsum_stream_handler", False)]
    assert len(marked) == 1
    # idempotent: repeated calls never stack duplicates
    get_logger("vnsum.other")
    get_logger()
    marked = [h for h in root.handlers
              if getattr(h, "_vnsum_stream_handler", False)]
    assert len(marked) == 1
    # and vnsum owns its emission: no propagation to the configured global
    # root, which would print every line twice
    assert root.propagate is False


def test_json_log_formatter_emits_one_json_object_per_line():
    from vnsum_tpu_torch.core.logging import JsonFormatter

    rec = logging.LogRecord(
        "vnsum.serve", logging.INFO, __file__, 1,
        "request %s done", ("req-1",), None,
    )
    line = JsonFormatter().format(rec)
    d = json.loads(line)
    assert d["level"] == "INFO" and d["logger"] == "vnsum.serve"
    assert d["msg"] == "request req-1 done"
    assert "ts" in d


def test_vnsum_log_json_env_selects_json_formatter(monkeypatch):
    from vnsum_tpu_torch.core import logging as vlog

    monkeypatch.setenv("VNSUM_LOG_JSON", "1")
    _fresh_vnsum_root()
    vlog.get_logger()
    root = logging.getLogger("vnsum")
    h = next(h for h in root.handlers
             if getattr(h, "_vnsum_stream_handler", False))
    assert isinstance(h.formatter, vlog.JsonFormatter)
    # restore a plain-format handler for the rest of the session
    monkeypatch.delenv("VNSUM_LOG_JSON")
    _fresh_vnsum_root()
    vlog.get_logger()
