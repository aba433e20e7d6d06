"""End-to-end request cancellation on the port's serving layer (the cases
of tests/test_serve_cancel.py that need no journal and no tenants): DELETE
semantics across every lifecycle stage, slot reclamation without requeue,
the cooperative one-shot flag, disconnect-triggered cancels, heartbeats,
and Last-Event-ID resume."""
from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import InflightScheduler, MicroBatchScheduler
from vnsum_tpu_torch.serve.queue import RequestCancelled
from vnsum_tpu_torch.serve.server import ServeState, make_server


def wait_for(pred, timeout_s: float = 10.0, interval_s: float = 0.01):
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


# -- scheduler-level lifecycle stages ----------------------------------------


def test_cancel_queued_request_resolves_typed():
    backend = FakeBackend(batch_overhead_s=0.15)
    sched = MicroBatchScheduler(backend, max_batch=1, max_wait_s=0.001)
    try:
        f1 = sched.submit("giu dong co ban " * 10, trace_id="busy-1")
        # wait until the engine is actually busy so c-1 stays queued
        assert wait_for(lambda: backend.batch_sizes)
        f2 = sched.submit("yeu cau se bi huy " * 10, trace_id="c-1")
        res = sched.cancel("c-1")
        assert res["known"] and res["cancelled_queued"] == 1
        with pytest.raises(RequestCancelled) as exc:
            f2.result(timeout=10)
        assert exc.value.stage == "queued"
        assert f1.result(timeout=10).text  # the survivor completes
        assert sched.queue.depth == 0
        snap = sched.metrics.snapshot()
        assert snap.cancelled.get("queued") == 1
        # idempotent: a second cancel of the same id answers known, 0 new
        res2 = sched.cancel("c-1")
        assert res2["known"] and res2["cancelled_queued"] == 0
    finally:
        sched.close()


def test_cancel_resident_slot_reclaimed_without_requeue_or_pins():
    backend = FakeBackend(segment_words=2, segment_overhead_s=0.02,
                          prefix_cache_blocks=64, cache_block_tokens=4)
    sched = InflightScheduler(backend, slots=2, max_wait_s=0.001)
    try:
        fut = sched.submit("van ban dai can tom tat " * 12, trace_id="r-1")
        # resident: segments are being dispatched for it
        assert wait_for(lambda: sched.metrics.snapshot().segments >= 2)
        sched.cancel("r-1")
        with pytest.raises(RequestCancelled) as exc:
            fut.result(timeout=10)
        assert exc.value.stage == "resident"
        snap = sched.metrics.snapshot()
        assert snap.cancelled.get("resident") == 1
        assert snap.requeues == 0 and snap.preemptions == 0  # NOT a preempt
        # the slot is free again and no prefix pins leaked
        assert wait_for(lambda: sched.slot_state()[1] == 0)
        assert backend.prefix_cache_stats()["pinned_blocks"] == 0
    finally:
        sched.close()


def test_cancel_resident_lands_within_one_fused_window():
    """--fused-segments coarsens the cancel sweep to host-dispatch
    cadence: a resident cancel must land at the NEXT fused boundary —
    at most the in-flight dispatch plus one, never several windows — and
    reclaim the slot without a requeue."""
    backend = FakeBackend(segment_words=2, segment_overhead_s=0.02)
    sched = InflightScheduler(backend, slots=2, max_wait_s=0.01,
                              fused_segments=4)
    try:
        fut = sched.submit("van ban dai can tom tat " * 12, trace_id="fz-1")
        assert wait_for(
            lambda: sched.metrics.snapshot().fused_dispatches >= 1
        )
        before = sched.metrics.snapshot().fused_dispatches
        sched.cancel("fz-1")
        with pytest.raises(RequestCancelled) as exc:
            fut.result(timeout=10)
        assert exc.value.stage == "resident"
        snap = sched.metrics.snapshot()
        # the sweep ran right after the in-flight dispatch retired: at most
        # one more full fused window elapsed before the cancel landed
        assert snap.fused_dispatches - before <= 2
        assert snap.cancelled.get("resident") == 1
        assert snap.requeues == 0
        assert wait_for(lambda: sched.slot_state()[1] == 0)
    finally:
        sched.close()


def test_cancel_dispatched_one_shot_cooperative_abort():
    """A cancelled one-shot batch stops burning (simulated) device time at
    the next segment boundary instead of decoding to completion, and the
    outcome is typed CANCELLED — never COMPLETE."""
    # ~40-word extractive output x 60ms/step = ~2.4s of decode if not cut
    backend = FakeBackend(per_step_s=0.06, segment_words=1)
    sched = MicroBatchScheduler(backend, max_batch=4, max_wait_s=0.001)
    try:
        t0 = time.monotonic()
        fut = sched.submit("noi dung rat dai se bi huy giua chung " * 8,
                           trace_id="d-1")
        assert wait_for(lambda: backend.batch_sizes)  # dispatch entered
        sched.cancel("d-1")
        with pytest.raises(RequestCancelled) as exc:
            fut.result(timeout=10)
        assert exc.value.stage in ("dispatched", "queued")
        assert time.monotonic() - t0 < 2.0  # aborted well before full decode
        assert backend.cancel_aborts >= 1
        assert sched.metrics.snapshot().cancelled
    finally:
        sched.close()


# -- HTTP surface -------------------------------------------------------------


@pytest.fixture()
def cancel_server():
    # ~30ms/segment x 20 segments = ~600ms decode per request: long enough
    # that a disconnect at the second event plus the 0.3s idle window lands
    # MID-decode (the cancel must reclaim a live slot, not observe a finish)
    state = ServeState(
        FakeBackend(segment_words=2, segment_overhead_s=0.03,
                    batch_overhead_s=0.005, prefix_cache_blocks=64,
                    cache_block_tokens=4),
        max_batch=4, max_wait_s=0.005, inflight=True, slots=4,
        stream_heartbeat_s=0.05, stream_idle_timeout_s=0.3,
    )
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()
    state.close()


def _req(base, method, path, payload=None, headers=None):
    import urllib.parse

    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        body = json.dumps(payload) if payload is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw) if raw else None
    finally:
        conn.close()


def test_delete_unknown_id_is_typed_404_and_get_regression(cancel_server):
    base, _state = cancel_server
    status, body = _req(base, "DELETE", "/v1/requests/khong-ton-tai")
    assert status == 404 and "error" in body
    # regression: GET of an unknown id is a typed 404, never a 500
    status, body = _req(base, "GET", "/v1/requests/khong-ton-tai")
    assert status == 404 and "error" in body


def test_delete_completed_request_is_idempotent(cancel_server):
    """With no journal a finished request is forgotten: DELETE answers the
    unknown id's typed 404, the same both times."""
    base, _state = cancel_server
    status, _ = _req(base, "POST", "/v1/generate",
                     {"prompt": "ngan gon", "request_id": "done-1"})
    assert status == 200
    for _ in range(2):  # idempotent: same answer both times
        status, body = _req(base, "DELETE", "/v1/requests/done-1")
        assert status == 404 and "error" in body


def test_delete_gang_cancels_summarize_fanout(cancel_server):
    base, state = cancel_server
    doc = "\n\n".join(
        f"Đoạn {i}: " + "nội dung dài cần tóm tắt kỹ lưỡng. " * 30
        for i in range(6)
    )
    results: dict = {}

    def run():
        try:
            results["resp"] = _req(
                base, "POST", "/v1/summarize",
                {"text": doc, "approach": "mapreduce",
                 "request_id": "gang-1"},
            )
        # worker thread: surface any client error to the assertion below
        except Exception as e:  # pragma: no cover - diagnostic aid
            results["error"] = e

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    # wait until the fan-out's second round is admitted, then cancel the
    # gang
    assert wait_for(lambda: len(state.backend.batch_sizes) >= 2, timeout_s=15)
    status, body = _req(base, "DELETE", "/v1/requests/gang-1")
    assert status == 200
    worker.join(timeout=30)
    assert not worker.is_alive()
    status, resp = results["resp"]
    assert status == 409 and resp["error"] == "cancelled"
    # the fan-out children were cancelled, and their slots reclaimed
    assert state.scheduler.metrics.snapshot().cancelled
    assert wait_for(lambda: state.scheduler.slot_state()[1] == 0)


def _read_sse_partial(base, payload, n_events: int, headers=None):
    """POST a streaming request, read ~n_events SSE frames, then DROP the
    connection without finishing — the disconnecting client."""
    import urllib.parse

    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    conn.request("POST", "/v1/generate", body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    assert resp.status == 200
    frames = 0
    buf = b""
    while frames < n_events:
        chunk = resp.fp.read1(4096)
        if not chunk:
            break
        buf += chunk
        frames = buf.count(b"\n\n")
    # drop the connection mid-stream (http.client hands the socket to the
    # response for Connection: close replies, so close through it)
    resp.close()
    conn.close()
    return buf.decode(errors="replace")


def test_disconnect_mid_stream_cancels_after_idle_window(cancel_server):
    base, state = cancel_server
    _read_sse_partial(
        base,
        {"prompt": "van ban rat dai can nhieu phan doan de tom tat " * 10,
         "stream": True, "request_id": "dis-1"},
        n_events=2,
    )
    # the 0.3s idle window expires -> the sweep cancels and reclaims
    assert wait_for(
        lambda: state.scheduler.metrics.snapshot().cancel_disconnects >= 1,
        timeout_s=10,
    )
    assert wait_for(lambda: state.scheduler.slot_state()[1] == 0)
    snap = state.scheduler.metrics.snapshot()
    assert snap.cancelled  # a stage counter moved
    assert snap.requeues == 0


@pytest.fixture()
def resume_server(tmp_path):
    # a WIDE idle window: the resume tests exercise reattach correctness,
    # not the sweep's timing — a slow CI box must not cancel under them
    state = ServeState(
        FakeBackend(segment_words=2, segment_overhead_s=0.02,
                    batch_overhead_s=0.005),
        max_batch=4, max_wait_s=0.005, inflight=True, slots=4,
        stream_heartbeat_s=0.05, stream_idle_timeout_s=10.0,
    )
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()
    state.close()


def test_stream_resume_with_last_event_id_preserves_identity(resume_server):
    base, _state = resume_server
    prompt = "tai lieu can tom tat theo tung phan doan mot " * 10
    expect = FakeBackend().generate([prompt])[0]
    head = _read_sse_partial(
        base, {"prompt": prompt, "stream": True, "request_id": "res-1"},
        n_events=2,
    )
    # the events read before the drop carry ids (the resume token)
    assert "id: " in head
    # reconnect within the idle window: snapshot + live deltas + done
    status_headers = {"Last-Event-ID": "1"}
    import urllib.parse

    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    conn.request(
        "POST", "/v1/generate",
        body=json.dumps({"prompt": prompt, "stream": True,
                         "request_id": "res-1"}),
        headers={"Content-Type": "application/json", **status_headers},
    )
    resp = conn.getresponse()
    assert resp.status == 200
    raw = resp.read().decode()
    conn.close()
    events = []
    for frame in raw.split("\n\n"):
        name = data = None
        for line in frame.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        if name:
            events.append((name, data))
    assert events[0][0] == "snapshot"
    assert events[-1][0] == "done"
    reassembled = events[0][1]["text"] + "".join(
        p["text"] for n, p in events if n == "delta"
    )
    assert reassembled == expect
    assert events[-1][1]["completions"][0]["text"] == expect
    assert _state.scheduler.metrics.snapshot().stream_resumes >= 1


def test_resume_unknown_stream_is_typed_404(resume_server):
    base, _state = resume_server
    status, body = _req(
        base, "POST", "/v1/generate",
        {"prompt": "bat ky", "stream": True, "request_id": "ghost-9"},
        headers={"Last-Event-ID": "5"},
    )
    assert status == 404 and "error" in body


def test_heartbeat_frames_emitted_on_quiet_stream(cancel_server):
    """Heartbeats need real quiet: saturate every slot with long requests
    first, so the streaming request sits queued (no deltas flowing) while
    the 50ms keepalive cadence emits comment frames."""
    base, state = cancel_server
    fillers = [
        threading.Thread(
            target=_req, args=(base, "POST", "/v1/generate"),
            kwargs={"payload": {"prompt": f"chiem cho {i} " * 40}},
            daemon=True,
        )
        for i in range(4)
    ]
    for t in fillers:
        t.start()
    assert wait_for(lambda: state.scheduler.slot_state()[1] == 4)
    import urllib.parse

    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    conn.request(
        "POST", "/v1/generate",
        body=json.dumps({"prompt": "noi dung cham rai " * 30,
                         "stream": True}),
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    for t in fillers:
        t.join(timeout=30)
    assert ": heartbeat" in raw
    assert state.scheduler.metrics.snapshot().stream_heartbeats >= 1


def test_nonstream_waiter_of_cancelled_request_gets_409(cancel_server):
    base, state = cancel_server
    results: dict = {}

    def run():
        results["resp"] = _req(
            base, "POST", "/v1/generate",
            {"prompt": "cho doi den khi bi huy " * 12,
             "request_id": "w-409"},
        )

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    assert wait_for(lambda: state.scheduler.slot_state()[1] >= 1)
    status, _ = _req(base, "DELETE", "/v1/requests/w-409")
    assert status == 200
    worker.join(timeout=30)
    status, body = results["resp"]
    assert status == 409
    assert body["error"] == "cancelled"
    assert body["request_id"] == "w-409"
