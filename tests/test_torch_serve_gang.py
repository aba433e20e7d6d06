"""Structured jobs (serve/gang.py) on the port's serving layer, the cases
of tests/test_serve_gang.py: gang admission, the
registry's lifecycle and its journal roundtrip, the queue's gang-affinity
pick, the summarize fan-out's gang counters, per-phase progress on the
poll surface, the POISON-degraded partial result of the strategies'
streaming rounds, gang-cancel mid-reduce (journaled and not), journal
replay of a half-finished gang, and whole-gang tier preemption."""
from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import (
    EngineSupervisor,
    InflightScheduler,
    MicroBatchScheduler,
    RetryPolicy,
    TenantTable,
    parse_tenant_specs,
)
from vnsum_tpu_torch.serve.gang import GangRegistry
from vnsum_tpu_torch.serve.journal import RequestJournal, aggregate_status
from vnsum_tpu_torch.serve.queue import RequestCancelled, RequestQueue, ServeRequest
from vnsum_tpu_torch.serve.scheduler import QueuedBackend
from vnsum_tpu_torch.serve.server import ServeState, make_server
from vnsum_tpu_torch.testing.faults import FaultPlan, FaultSpec, injected

FAST = RetryPolicy(max_attempts=2, backoff_base_s=0.005, backoff_max_s=0.05,
                   jitter=0.0)


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

    for i in range(3):
        reg.note_member("g1", f"g1#{i}" if i else "g1", "map")
    reg.note_member("g1", None, "map")  # journal off: counted, no identity
    reg.mark_partial("g1")
    reg.mark_partial("g1")  # idempotent
    assert reg.lookup("g1") == {
        "members": {"g1": "map", "g1#1": "map", "g1#2": "map"}, "partial": True}
    # no journal: a flush hands the round over and appends nothing
    assert reg.flush("g1") == 3 and reg.flush("g1") == 0

    # membership noted for an unknown gang is a silent no-op (shed child)
    reg.note_member("khong-co", "x", "map")
    assert reg.lookup("khong-co") is None

    h.finish()
    assert reg.active() == 0 and reg.lookup("g1") is None
    h.finish()  # idempotent
    assert reg.active() == 0


def test_gang_registry_lifecycle_and_journal_roundtrip(tmp_path):
    j = RequestJournal(tmp_path)
    reg = GangRegistry(journal=j)
    h = reg.open("g1")
    reg.open("g1")  # idempotent: a retry rejoins, never forks a 2nd group
    assert reg.active() == 1

    reg.note_member("g1", "g1", "map")
    reg.note_member("g1", "g1#1", "map")
    assert reg.flush("g1") == 2  # one typed GANG record for the round
    assert reg.flush("g1") == 0  # nothing new -> no append
    assert j.gang_info("g1") == {
        "members": {"g1": "map", "g1#1": "map"}, "partial": False,
    }

    reg.note_member("g1", "g1#2", "reduce")
    reg.mark_partial("g1")
    reg.mark_partial("g1")  # idempotent: one degradation record
    info = reg.lookup("g1")
    assert info["partial"] is True and len(info["members"]) == 3

    # membership noted for an unknown gang is a silent no-op (shed child)
    reg.note_member("khong-co", "x", "map")
    assert reg.lookup("khong-co") is None

    # finish flushes the straggler first — the ledger never loses members
    h.finish()
    assert reg.active() == 0 and reg.lookup("g1") is None
    assert j.gang_info("g1")["members"]["g1#2"] == "reduce"
    j.close()

    # the read-only audit view (chaos soak) sees the same truth
    gangs = RequestJournal.read_gangs(tmp_path)
    assert gangs["g1"]["partial"] is True
    assert len(gangs["g1"]["members"]) == 3

    # restore() pre-seeds replayed groups as flushed, partiality intact
    reg2 = GangRegistry()
    assert reg2.restore({"g1": {"members": {"a": "map"}, "partial": True}}) == 1
    assert reg2.lookup("g1") == {"members": {"a": "map"}, "partial": True}
    assert reg2.restore({"g1": {"members": {}, "partial": False}}) == 0


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


# -- the journal: per-phase progress, degraded results, cancel, replay ----


def test_request_status_reports_per_phase_progress(tmp_path):
    base, state, server = _serve(journal_dir=str(tmp_path / "journal"))
    try:
        status, resp = _req(base, "POST", "/v1/summarize",
                            {"text": DOC, "approach": "mapreduce",
                             "request_id": "sj-1"})
        assert status == 200 and resp["summary"]
        assert "partial" not in resp  # clean run: no degradation marker

        status, body = _req(base, "GET", "/v1/requests/sj-1")
        assert status == 200 and body["status"] == "completed"
        gang = body["gang"]
        assert gang["partial"] is False
        phases = gang["phases"]
        # schema regression: exact per-phase keys — a polling client parses
        # these, so a rename is a breaking change
        assert set(phases) == {"map", "reduce"}
        for ph in phases.values():
            assert set(ph) == {"total", "done", "failed", "running",
                               "streaming"}
            assert ph["done"] == ph["total"] > 0
            assert ph["failed"] == ph["running"] == ph["streaming"] == 0
        assert gang["members"] == sum(p["total"] for p in phases.values())
        assert phases["map"]["total"] >= 2  # it actually fanned out

        # gang counters made it to the aggregate snapshot + scrape surface
        snap = state.scheduler.metrics.snapshot()
        assert snap.gang_admitted >= 1
        assert snap.gang_members >= gang["members"]
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


# -- degraded results: POISON member -> partial ------------------------------


def test_poison_member_degrades_to_partial_terminal_state(tmp_path):
    doc = "\n\n".join(
        f"Đoạn {i}: " + ("DOC-POISON doc hai. " if i == 3 else
                         "nội dung dài cần tóm tắt kỹ lưỡng. ") * 200
        for i in range(18)
    )
    base, state, server = _serve(
        journal_dir=str(tmp_path / "journal"), supervisor=EngineSupervisor(FAST),
    )
    try:
        plan = FaultPlan(
            [FaultSpec(site="fake.dispatch", kind="poison",
                       match="DOC-POISON")]
        )
        with injected(plan):
            status, resp = _req(base, "POST", "/v1/summarize",
                                {"text": doc, "approach": "mapreduce",
                                 "request_id": "pj-1"})
        # degraded, not failed: the reduce ran over the survivors and the
        # reply says so inline
        assert status == 200
        assert resp["partial"] is True and resp["summary"]

        # the journal agrees terminally: FAILED child + COMPLETE siblings,
        # all terminal -> the shared fold answers "partial"
        assert wait_for(lambda: all(
            e.terminal for e in state.journal.lookup("pj-1")))
        entries = state.journal.lookup("pj-1")
        assert aggregate_status(entries) == "partial"
        assert any(e.status == "failed" for e in entries)
        assert state.journal.gang_info("pj-1")["partial"] is True

        status, body = _req(base, "GET", "/v1/requests/pj-1")
        assert status == 200 and body["status"] == "partial"
        assert body["gang"]["partial"] is True
        assert body["gang"]["phases"]["map"]["failed"] == 1
        assert state.scheduler.metrics.snapshot().gang_partials == 1
    finally:
        server.shutdown()
        server.server_close()
        state.close()


# -- gang-cancel mid-reduce, journaled --------------------------------------


def test_gang_cancel_mid_reduce_journals_cancelled(tmp_path):
    """Cancel lands between the map round and the reduce's dispatch: the
    reduce resolves typed-cancelled, the completed maps stay COMPLETE, and
    the shared fold answers \"cancelled\" for the parent aggregate."""
    journal = RequestJournal(tmp_path / "j")
    backend = FakeBackend(batch_overhead_s=0.25)
    sched = MicroBatchScheduler(backend, max_batch=1, max_wait_s=0.001,
                                journal=journal)
    try:
        handle = sched.admit_gang("gc-1")
        qb = QueuedBackend(sched, trace_id="gc-1", gang="gc-1")
        maps = qb.submit_round(["chunk mot " * 8, "chunk hai " * 8],
                               phase="map")
        texts = [qb.harvest(f) for f in maps]
        assert all(texts)
        # park a blocker on the single-dispatch engine so the reduce stays
        # QUEUED long enough for the cancel to win the race
        blocker = sched.submit("giu dong co " * 10, trace_id="blk-1")
        assert wait_for(lambda: len(backend.batch_sizes) >= 3)
        (rfut,) = qb.submit_round(["tong hop: " + " ".join(texts)],
                                  phase="reduce")
        res = sched.cancel("gc-1")
        assert res["known"] and res["cancelled_queued"] == 1
        with pytest.raises(RequestCancelled) as exc:
            rfut.result(timeout=15)
        assert exc.value.stage == "queued"
        handle.finish()
        assert blocker.result(timeout=15).text  # the bystander survives
    finally:
        sched.close()
        journal.close()

    # the gang's ledger: membership round-trips, maps complete, reduce
    # cancelled, and the group folds to "cancelled" — never "completed"
    gangs = RequestJournal.read_gangs(tmp_path / "j")
    assert set(gangs["gc-1"]["members"].values()) == {"map", "reduce"}
    entries, _sealed, _torn = RequestJournal.read_state(tmp_path / "j")
    mine = [e for rid, e in entries.items() if rid.split("#")[0] == "gc-1"]
    assert len(mine) == 3 and all(e.terminal for e in mine)
    assert aggregate_status(mine) == "cancelled"


# -- journal replay of a half-finished gang ----------------------------------


def test_replay_restores_half_finished_gang(tmp_path):
    """Crash after the maps completed but before the reduce ran: replay
    must rebuild the LIVE group from the typed GANG records (not trace
    prefixes), re-run only the reduce, and finish byte-identical."""
    jdir = tmp_path / "journal"
    j = RequestJournal(jdir)
    reduce_prompt = "tong hop cac y chinh " * 8
    rids = []
    for i, (prompt, phase) in enumerate([
        ("phan mot " * 8, "map"),
        ("phan hai " * 8, "map"),
        (reduce_prompt, "reduce"),
    ]):
        r = ServeRequest(prompt=prompt, trace_id="g-1", gang_id="g-1",
                         gang_phase=phase)
        rids.append(j.accept(r))
    assert rids == ["g-1", "g-1#1", "g-1#2"]
    j.gang("g-1", [(rid, ph) for rid, ph in
                   zip(rids, ["map", "map", "reduce"])])
    for rid in rids[:2]:
        j.start(rid)
        j.complete(rid, f"xong {rid}", gen_tokens=2)
    j.close()  # no seal: simulated crash with the reduce still pending

    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005,
                       journal_dir=str(jdir))
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # the gang is restored BEFORE any entry is re-enqueued
        restored = state.replay_journal()
        assert restored == 1  # only the reduce was unfinished
        live = state.scheduler.gangs.lookup("g-1")
        assert live is not None and len(live["members"]) == 3

        assert wait_for(lambda: all(
            e.terminal for e in state.journal.lookup("g-1")))
        by_rid = {e.rid: e for e in state.journal.lookup("g-1")}
        # byte-identity: the replayed reduce matches an uninterrupted run
        assert by_rid["g-1#2"].status == "complete"
        assert by_rid["g-1#2"].text == FakeBackend().generate(
            [reduce_prompt])[0]
        # completed maps were NOT re-run (their texts are the pre-crash
        # ones, and replay enqueued exactly one request)
        assert by_rid["g-1"].text == "xong g-1"

        status, body = _req(base, "GET", "/v1/requests/g-1")
        assert status == 200 and body["status"] == "completed"
        phases = body["gang"]["phases"]
        assert phases["map"] == {"total": 2, "done": 2, "failed": 0,
                                 "running": 0, "streaming": 0}
        assert phases["reduce"]["done"] == 1
    finally:
        server.shutdown()
        server.server_close()
        state.close()


# -- whole-gang preemption ----------------------------------------------------


def test_preemption_evicts_whole_gang_byte_identical():
    """One interactive arrival needs ONE slot, but the resident fan-out is
    a gang: eviction takes the WHOLE group (never strands a half-finished
    fan-out holding pins), both members requeue, and their final outputs
    stay byte-identical to an unpreempted run."""
    tenants = TenantTable(parse_tenant_specs("interactive:4:0,batch:1:0:batch"))
    backend = FakeBackend(segment_words=4, segment_overhead_s=0.005,
                          batch_overhead_s=0.01)
    sched = InflightScheduler(backend, slots=2, max_wait_s=0.01,
                              tenants=tenants)
    try:
        handle = sched.admit_gang("gp-1", tenant="batch")
        prompts = ["phan tich chuyen sau noi dung " * 12 + f" so {i}"
                   for i in range(2)]
        futs = [
            sched.submit(p, tenant="batch", tier="batch", gang="gp-1",
                         gang_phase="map")
            for p in prompts
        ]
        time.sleep(0.03)  # both gang members resident, a few segments deep
        i_c = sched.submit("ngan gon", tenant="interactive").result(timeout=30)
        assert i_c.record.status == "ok"
        texts = [f.result(timeout=30).text for f in futs]
        handle.finish()
        snap = sched.metrics.snapshot()
        # demand was ONE slot; the gang granularity evicted BOTH members
        # together and counted one whole-gang preemption
        assert snap.gang_preemptions >= 1
        assert snap.preemptions >= 2 and snap.preemptions % 2 == 0
        assert snap.requeues == snap.preemptions  # nobody stranded
        for p, text in zip(prompts, texts):
            assert text == FakeBackend().generate([p])[0]
    finally:
        sched.close()
