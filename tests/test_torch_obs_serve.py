"""Integration tests for end-to-end request tracing through the serving
path: span propagation across the scheduler thread under concurrency (ids
never cross-contaminate), TTFT/e2e histogram emission, request-id
consistency across response header / trace dump / ServeRequestRecord, the
/debug/trace endpoint, and the tracing-disabled overhead guard."""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.obs import ObsHub, RequestTrace
from vnsum_tpu_torch.serve import MicroBatchScheduler
from vnsum_tpu_torch.serve.server import ServeState, make_server

DOC = "\n\n".join(
    f"Đoạn văn {i}: " + "nội dung tiếng Việt có dấu thanh. " * 25
    for i in range(4)
)


# -- span propagation across scheduler threads -------------------------------


def test_concurrent_traces_never_cross_contaminate():
    """N requests submitted from N threads coalesce into shared engine
    batches; every request's spans must land on ITS OWN trace with its own
    id — the trace rides the ServeRequest across the queue handoff, so no
    thread-local confusion is possible."""
    hub = ObsHub(sample=1.0, ring=64)
    sched = MicroBatchScheduler(
        FakeBackend(), max_batch=8, max_wait_s=0.25, obs=hub
    )
    try:
        n = 6
        barrier = threading.Barrier(n)
        results = [None] * n

        def worker(i):
            barrier.wait()
            results[i] = sched.submit(
                f"tai lieu {i} " * 10, trace_id=f"client-{i}"
            ).result(timeout=30)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # all coalesced into one engine batch, yet ids stayed per-request
        assert all(r.record.batch_size == n for r in results)
        assert [r.record.trace_id for r in results] == [
            f"client-{i}" for i in range(n)
        ]
        reqs, batches = hub.snapshot()
        assert {t.trace_id for t in reqs} == {f"client-{i}" for i in range(n)}
        for tr in reqs:
            ids = {
                s.args["request_id"]
                for s in tr.spans
                if s.name == "queue_wait" and s.args
            }
            assert len(ids) == 1  # exactly one queue-level id per trace
            names = {s.name for s in tr.spans}
            assert {"queue_wait", "engine", "postprocess", "request"} <= names
        # the shared batch is one track with the fake's phase events on it
        assert len(batches) == 1 and batches[0].occupancy == n
        assert [e.name for e in batches[0].events] == ["prefill", "decode"]
    finally:
        sched.close()


def test_batch_prefill_anchors_ttft_between_queue_wait_and_total():
    backend = FakeBackend(batch_overhead_s=0.05, per_prompt_s=0.01)
    hub = ObsHub(sample=1.0)
    sched = MicroBatchScheduler(
        backend, max_batch=4, max_wait_s=0.0, obs=hub
    )
    try:
        rec = sched.submit("do ttft " * 5).result(timeout=30).record
        # prefill (50ms) ends before decode (10ms) does: TTFT must sit
        # strictly inside [queue_wait, total]
        assert rec.queue_wait_s <= rec.ttft_s <= rec.total_s
        assert rec.ttft_s < rec.queue_wait_s + rec.engine_s
    finally:
        sched.close()


def test_scheduler_owned_traces_finish_on_shed():
    import time

    hub = ObsHub(sample=1.0)
    sched = MicroBatchScheduler(
        FakeBackend(), max_batch=4, max_wait_s=0.0, obs=hub
    )
    try:
        from vnsum_tpu_torch.serve import RequestShed

        with pytest.raises(RequestShed):
            sched.submit("het han ", deadline=time.monotonic() - 1.0)
        reqs, _ = hub.snapshot()
        assert len(reqs) == 1 and reqs[0].status == "shed:deadline"
    finally:
        sched.close()


def test_owned_sampling_decision_is_not_redrawn_per_prompt():
    """An entry point that sampled its request OUT (trace=None,
    trace_owned=True) must not have the scheduler re-draw per fanned-out
    prompt — that would fragment one request into single-prompt traces and
    inflate the configured sample rate."""
    hub = ObsHub(sample=1.0, ring=64)
    sched = MicroBatchScheduler(
        FakeBackend(), max_batch=8, max_wait_s=0.1, obs=hub
    )
    try:
        outs = sched.generate_sync(
            [f"phan manh {i} " * 5 for i in range(4)],
            trace=None, trace_owned=True,
        )
        assert len(outs) == 4
        reqs, _ = hub.snapshot()
        assert reqs == []  # no scheduler-owned traces were conjured
    finally:
        sched.close()


# -- overhead guard: tracing disabled = no per-request allocations -----------


def test_disabled_tracing_allocates_no_traces_and_emits_nothing():
    before = RequestTrace.allocations
    sched = MicroBatchScheduler(FakeBackend(), max_batch=4, max_wait_s=0.01,
                                obs=None)
    try:
        for i in range(8):
            c = sched.submit(f"khong theo doi {i} " * 6).result(timeout=30)
            assert c.record.status == "ok"
            assert c.record.trace_id  # correlation ids still flow
    finally:
        sched.close()
    # zero RequestTrace objects constructed anywhere in the process while
    # 8 requests (and their tokens) were served: the disabled path's cost
    # is `is None` checks, not per-token or per-request tracing state
    assert RequestTrace.allocations == before


# -- HTTP: ids, histograms, /debug/trace -------------------------------------


@pytest.fixture()
def serve_url():
    state = ServeState(
        FakeBackend(batch_overhead_s=0.005),
        max_batch=8, max_wait_s=0.005, trace_sample=1.0, trace_ring=64,
    )
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()
    state.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def test_request_id_consistent_across_header_body_record_and_trace(serve_url):
    base, state = serve_url
    status, headers, d = _post(
        base + "/v1/generate",
        {"prompt": "xin chào " * 8, "request_id": "my-req-42"},
    )
    assert status == 200
    assert headers["X-Request-Id"] == "my-req-42"
    assert d["request_id"] == "my-req-42"
    (c,) = d["completions"]
    assert c["record"]["trace_id"] == "my-req-42"
    assert c["record"]["ttft_s"] >= 0.0
    # the same id names the request's track in the trace dump
    _, _, body = _get(base + "/debug/trace")
    doc = json.loads(body)
    procs = {
        e["args"]["name"] for e in doc["traceEvents"]
        if e["ph"] == "M" and e["name"] == "process_name"
    }
    assert "request my-req-42" in procs


def test_request_id_from_header_and_generated_fallback(serve_url):
    base, _ = serve_url
    _, headers, d = _post(
        base + "/v1/generate", {"prompt": "một " * 6},
        headers={"X-Request-Id": "hdr-id-7"},
    )
    assert headers["X-Request-Id"] == "hdr-id-7" == d["request_id"]
    _, headers, d = _post(base + "/v1/generate", {"prompt": "hai " * 6})
    assert d["request_id"] and headers["X-Request-Id"] == d["request_id"]


def test_bad_request_id_is_400(serve_url):
    base, _ = serve_url
    for bad in (17, "", "x" * 200):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/v1/generate", {"prompt": "x", "request_id": bad})
        assert exc.value.code == 400


def test_summarize_returns_request_id_and_one_trace_for_all_rounds(serve_url):
    base, state = serve_url
    status, headers, d = _post(
        base + "/v1/summarize",
        {"text": DOC, "approach": "mapreduce", "request_id": "sum-1"},
    )
    assert status == 200 and d["request_id"] == "sum-1"
    assert headers["X-Request-Id"] == "sum-1"
    reqs, _ = state.obs.snapshot()
    tr = next(t for t in reqs if t.trace_id == "sum-1")
    # every strategy-round prompt recorded onto this ONE trace, each on its
    # own sub-track
    engine_spans = [s for s in tr.spans if s.name == "engine"]
    assert len(engine_spans) == d["llm_calls"]
    assert len({s.track for s in engine_spans}) == len(engine_spans)


def test_metrics_histograms_have_nonempty_buckets(serve_url):
    base, _ = serve_url
    for i in range(3):
        _post(base + "/v1/generate", {"prompt": f"đo {i} " * 6})
    _, _, body = _get(base + "/metrics")
    text = body.decode()
    for name in ("vnsum_serve_queue_wait_seconds",
                 "vnsum_serve_ttft_seconds",
                 "vnsum_serve_e2e_seconds",
                 "vnsum_serve_batch_occupancy"):
        assert f'{name}_bucket{{le="+Inf"}} 3' in text, name
        assert f"{name}_count 3" in text
        assert f"{name}_sum" in text
    assert "vnsum_serve_spec_accepted_per_step_bucket" in text
    assert "vnsum_serve_spec_acceptance_rolling 0" in text
    assert "vnsum_serve_tokens_per_second_rolling" in text


def test_spec_histograms_flow_from_fake_spec_records():
    state = ServeState(
        FakeBackend(spec_k=4, spec_acceptance=0.5),
        max_batch=4, max_wait_s=0.005,
    )
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _post(base + "/v1/generate",
              {"prompt": "nguồn " * 10, "reference": "nguồn " * 10})
        _, _, body = _get(base + "/metrics")
        text = body.decode()
        assert "vnsum_serve_spec_accepted_per_step_count 1" in text
        # rolling acceptance reflects the fake's 0.5 rate
        assert "vnsum_serve_spec_acceptance_rolling 0.5" in text
    finally:
        server.shutdown()
        server.server_close()
        state.close()


def test_debug_trace_is_perfetto_loadable_with_batch_and_request_tracks(
    serve_url,
):
    base, _ = serve_url
    _post(base + "/v1/generate", {"prompt": "dấu vết " * 6})
    status, headers, body = _get(base + "/debug/trace")
    assert status == 200
    assert headers["Content-Type"] == "application/json"
    doc = json.loads(body)
    assert doc["displayTimeUnit"] == "ms"
    pids = set()
    for e in doc["traceEvents"]:
        assert e["ph"] in ("X", "M")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
        pids.add(e["pid"])
    assert 1 in pids          # engine process (batch tracks)
    assert any(p >= 100 for p in pids)  # at least one request process
    slice_names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "queue_wait" in slice_names and "prefill" in slice_names


def test_debug_trace_404_when_tracing_disabled():
    state = ServeState(FakeBackend(), max_batch=2, max_wait_s=0.005,
                       trace_sample=0.0)
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert state.obs is None
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/debug/trace")
        assert exc.value.code == 404
        # histograms stay on even with tracing off...
        _post(base + "/v1/generate", {"prompt": "vẫn đo " * 6})
        _, _, body = _get(base + "/metrics")
        text = body.decode()
        assert 'vnsum_serve_e2e_seconds_bucket{le="+Inf"} 1' in text
        # ...EXCEPT TTFT, which has no prefill anchor without a batch trace:
        # an unanchored fallback would just be e2e relabeled
        assert "vnsum_serve_ttft_seconds_count 0" in text
    finally:
        server.shutdown()
        server.server_close()
        state.close()
