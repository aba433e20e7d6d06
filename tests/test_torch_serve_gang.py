"""Structured jobs (serve/gang.py) on the port's serving layer, the cases
of tests/test_serve_gang.py that need no journal and no tenants: gang
admission and the registry's lifecycle, the queue's gang-affinity pick,
the summarize fan-out's gang counters, and gang-cancel mid-reduce. The
POISON-degraded partial result rides the strategies' streaming rounds and
comes with them (ROADMAP A15b)."""
from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import MicroBatchScheduler
from vnsum_tpu_torch.serve.gang import GangRegistry
from vnsum_tpu_torch.serve.queue import RequestCancelled, RequestQueue, ServeRequest
from vnsum_tpu_torch.serve.scheduler import QueuedBackend
from vnsum_tpu_torch.serve.server import ServeState, make_server


def wait_for(pred, timeout_s: float = 15.0, interval_s: float = 0.01):
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


def _req(base, method, path, payload=None, headers=None):
    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
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


def _serve(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_s", 0.005)
    state = ServeState(FakeBackend(), **kw)
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}", state, server


# big enough that the mapreduce splitter yields SEVERAL map chunks under
# the default chunk budget (12000 whitespace tokens on the FakeBackend) —
# the tests below assert a real fan-out, not a single-chunk degenerate case
DOC = "\n\n".join(
    f"Đoạn {i}: " + "nội dung dài cần tóm tắt kỹ lưỡng. " * 200
    for i in range(18)
)


# -- registry lifecycle -------------------------------------------------------


def test_gang_registry_lifecycle():
    reg = GangRegistry()
    h = reg.open("g1")
    reg.open("g1")  # idempotent: a retry rejoins, never forks a 2nd group
    assert reg.active() == 1

    for _ in range(3):
        reg.note_member("g1")
    reg.mark_partial("g1")
    reg.mark_partial("g1")  # idempotent
    assert reg.lookup("g1") == {"members": 3, "partial": True}

    # membership noted for an unknown gang is a silent no-op (shed child)
    reg.note_member("khong-co")
    assert reg.lookup("khong-co") is None

    h.finish()
    assert reg.active() == 0 and reg.lookup("g1") is None
    h.finish()  # idempotent
    assert reg.active() == 0


# -- queue affinity pick ------------------------------------------------------


def _row(prompt, gang=""):
    return ServeRequest(prompt=prompt, est_tokens=1, gang_id=gang)


def test_gang_affinity_pick_clusters_siblings():
    """An over-full take keeps the head row's gang together — siblings land
    in ONE slot generation (warm shared prefix, whole-gang preemption)."""
    q = RequestQueue(max_depth=16)
    order = [("a0", "ga"), ("b0", "gb"), ("a1", "ga"), ("b1", "gb"),
             ("a2", "ga")]
    for p, g in order:
        q.submit(_row(p, g))
    batch = q.take_batch(3, 0.0)
    assert [r.prompt for r in batch] == ["a0", "a1", "a2"]
    # the other gang drains next, still whole
    assert [r.prompt for r in q.take_batch(3, 0.0)] == ["b0", "b1"]


def test_gang_affinity_off_restores_fifo_packing():
    """queue.gang_affinity = False (--no-gang-affinity) is the bench A/B
    lever: same queue content, pre-gang FIFO-prefix packing."""
    q = RequestQueue(max_depth=16)
    q.gang_affinity = False
    for p, g in [("a0", "ga"), ("b0", "gb"), ("a1", "ga"), ("b1", "gb"),
                 ("a2", "ga")]:
        q.submit(_row(p, g))
    batch = q.take_batch(3, 0.0)
    assert [r.prompt for r in batch] == ["a0", "b0", "a1"]


# -- the summarize fan-out's gang counters ----------------------------------


def test_summarize_fanout_gang_counters():
    base, state, server = _serve()
    try:
        status, resp = _req(base, "POST", "/v1/summarize",
                            {"text": DOC, "approach": "mapreduce",
                             "request_id": "sj-1"})
        assert status == 200 and resp["summary"]
        assert "partial" not in resp  # clean run: no degradation marker
        assert resp["num_chunks"] >= 2  # it actually fanned out
        # with no journal the poll surface answers a typed 404
        status, body = _req(base, "GET", "/v1/requests/sj-1")
        assert status == 404 and "error" in body

        # gang counters made it to the aggregate snapshot + scrape surface
        snap = state.scheduler.metrics.snapshot()
        assert snap.gang_admitted >= 1
        assert snap.gang_members >= resp["llm_calls"]
        u = urllib.parse.urlparse(base)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        assert "vnsum_serve_gang_admitted_total" in text
        assert "vnsum_serve_gang_active 0" in text  # handle finished
        assert state.scheduler.gangs.active() == 0
    finally:
        server.shutdown()
        server.server_close()
        state.close()


# -- gang-cancel mid-reduce ---------------------------------------------------


def test_gang_cancel_mid_reduce():
    """Cancel lands between the map round and the reduce's dispatch: the
    reduce resolves typed-cancelled and a bystander survives."""
    backend = FakeBackend(batch_overhead_s=0.25)
    sched = MicroBatchScheduler(backend, max_batch=1, max_wait_s=0.001)
    try:
        handle = sched.admit_gang("gc-1")
        qb = QueuedBackend(sched, trace_id="gc-1", gang="gc-1")
        maps = qb.submit_round(["chunk mot " * 8, "chunk hai " * 8])
        texts = [qb.harvest(f) for f in maps]
        assert all(texts)
        # park a blocker on the single-dispatch engine so the reduce stays
        # QUEUED long enough for the cancel to win the race
        blocker = sched.submit("giu dong co " * 10, trace_id="blk-1")
        assert wait_for(lambda: len(backend.batch_sizes) >= 3)
        (rfut,) = qb.submit_round(["tong hop: " + " ".join(texts)])
        res = sched.cancel("gc-1")
        assert res["known"] and res["cancelled_queued"] == 1
        with pytest.raises(RequestCancelled) as exc:
            rfut.result(timeout=15)
        assert exc.value.stage == "queued"
        handle.finish()
        assert blocker.result(timeout=15).text  # the bystander survives
    finally:
        sched.close()
