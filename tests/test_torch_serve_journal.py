"""Durable serving on the port (serve/journal.py, testing/chaos.py): the
cases of tests/test_serve_journal.py on the port's imports and its
FakeBackend (record properties: CRC, torn tails, rotation under concurrent
writers, replay idempotence; scheduler lifecycle integration; restart
replay byte-identity; the HTTP poll surface; the chaos helpers' seeded
determinism; the inspection CLI), then the cross-package format (the two
packages' ``_encode`` give equal bytes, a journal either package writes
reads equally in the other) and a SIGKILLed server process whose
unfinished requests replay byte-identically after a restart.

The JAX file's cross-process handoff case runs on the port's
``request_body_from_payload`` (serve/router.py): a SIGKILLed server's
unfinished ACCEPTs re-dispatched by hand onto a second server complete
byte-identically."""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve.journal import RequestJournal, _encode
from vnsum_tpu_torch.serve.queue import RequestShed, ServeRequest
from vnsum_tpu_torch.serve.scheduler import MicroBatchScheduler
from vnsum_tpu_torch.serve.server import ServeState, make_server
from vnsum_tpu_torch.testing.chaos import KillSchedule, free_port


def _req(prompt="văn bản cần tóm tắt " * 8, trace_id="t-1", **kw):
    return ServeRequest(prompt=prompt, trace_id=trace_id, **kw)


def _segments(directory):
    return sorted(directory.glob("journal.*.jsonl"))


# -- record / recovery properties -------------------------------------------


def test_lifecycle_roundtrip_and_reopen(tmp_path):
    j = RequestJournal(tmp_path)
    rid = j.accept(_req(trace_id="a"))
    assert rid == "a"
    j.start(rid)
    j.complete(rid, "kết quả tóm tắt", gen_tokens=3)
    rid2 = j.accept(_req(trace_id="b"))
    j.fail(rid2, "shed:deadline", "expired")
    j.close()  # no seal: simulated crash

    j2 = RequestJournal(tmp_path)
    (a,) = j2.lookup("a")
    assert a.status == "complete" and a.text == "kết quả tóm tắt"
    assert a.gen_tokens == 3
    (b,) = j2.lookup("b")
    assert b.status == "failed" and b.reason == "shed:deadline"
    assert j2.pending() == 0 and not j2.recovered_sealed
    j2.close()


def test_fanout_rids_and_lookup_children(tmp_path):
    j = RequestJournal(tmp_path)
    rids = [j.accept(_req(trace_id="req")) for _ in range(3)]
    assert rids == ["req", "req#1", "req#2"]
    assert {e.rid for e in j.lookup("req")} == set(rids)
    # a different trace never leaks into the prefix match
    j.accept(_req(trace_id="req2"))
    assert {e.rid for e in j.lookup("req")} == set(rids)
    j.close()


def test_crc_rejects_torn_tail(tmp_path):
    j = RequestJournal(tmp_path)
    j.accept(_req(trace_id="keep"))
    j.complete("keep", "done")
    j.accept(_req(trace_id="torn"))
    j.close()
    # tear the last record mid-line, like a kill mid-write leaves it
    (seg,) = _segments(tmp_path)
    data = seg.read_bytes()
    seg.write_bytes(data[:-17])

    entries, sealed, torn = RequestJournal.read_state(tmp_path)
    assert torn == 1
    assert "torn" not in entries  # the torn ACCEPT is dropped, not garbage
    assert entries["keep"].status == "complete"


def test_crc_rejects_corrupt_record_and_stops_trusting_segment(tmp_path):
    j = RequestJournal(tmp_path)
    for t in ("a", "b", "c"):
        j.accept(_req(trace_id=t))
    j.close()
    (seg,) = _segments(tmp_path)
    lines = seg.read_bytes().splitlines(keepends=True)
    # flip a byte inside record b's JSON body: CRC must catch it and the
    # reader must stop trusting everything after it in this segment
    lines[1] = lines[1][:15] + b"X" + lines[1][16:]
    seg.write_bytes(b"".join(lines))

    entries, _sealed, torn = RequestJournal.read_state(tmp_path)
    assert torn == 1
    assert set(entries) == {"a"}


def test_sealed_journal_compacts_on_reopen(tmp_path):
    j = RequestJournal(tmp_path, max_segment_bytes=400)
    for i in range(8):
        rid = j.accept(_req(trace_id=f"r{i}"))
        j.complete(rid, f"out-{i}")
    assert j.rotations > 0 and len(_segments(tmp_path)) > 1
    j.seal()
    j.close()

    j2 = RequestJournal(tmp_path)
    assert j2.recovered_sealed
    # compaction rewrote live state into ONE fresh segment (atomically)
    assert len(_segments(tmp_path)) == 1
    for i in range(8):
        (e,) = j2.lookup(f"r{i}")
        assert e.status == "complete" and e.text == f"out-{i}"
    j2.close()


def test_rotation_under_concurrent_writers(tmp_path):
    j = RequestJournal(tmp_path, max_segment_bytes=2048)
    n_threads, per_thread = 6, 40
    errors = []

    def writer(t):
        try:
            for i in range(per_thread):
                rid = j.accept(_req(trace_id=f"w{t}-{i}"))
                j.start(rid)
                j.complete(rid, f"text-{t}-{i}")
        except Exception as e:  # pragma: no cover - the assertion below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert j.rotations > 0  # the property under test actually exercised
    j.close()

    # every record survives rotation, exactly once, with its final state
    entries, _sealed, torn = RequestJournal.read_state(tmp_path)
    assert torn == 0
    assert len(entries) == n_threads * per_thread
    for t in range(n_threads):
        for i in range(per_thread):
            e = entries[f"w{t}-{i}"]
            assert e.status == "complete" and e.text == f"text-{t}-{i}"


def test_accept_is_idempotent_per_rid(tmp_path):
    j = RequestJournal(tmp_path)
    req = _req(trace_id="once")
    j.accept(req)
    before = j.records
    # replay resubmission path: journal_rid preset -> no duplicate ACCEPT
    j.accept(req)
    assert j.records == before
    assert len(j.lookup("once")) == 1
    j.close()


def test_take_unfinished_hands_each_entry_out_once(tmp_path):
    j = RequestJournal(tmp_path)
    j.accept(_req(trace_id="u1"))
    j.accept(_req(trace_id="u2"))
    rid = j.accept(_req(trace_id="done"))
    j.complete(rid, "x")
    j.close()

    j2 = RequestJournal(tmp_path)
    first = {e.rid for e in j2.take_unfinished()}
    assert first == {"u1", "u2"}
    # replaying twice enqueues once: the second take returns nothing
    assert j2.take_unfinished() == []
    j2.close()


def test_terminal_eviction_keeps_unfinished_and_bounds_history(tmp_path):
    j = RequestJournal(tmp_path, keep_terminal=5)
    j.accept(_req(trace_id="open"))
    for i in range(12):
        rid = j.accept(_req(trace_id=f"d{i}"))
        j.complete(rid, "x")
    assert j.pending() == 1  # the open entry is never evicted
    assert len(j.lookup("open")) == 1
    assert sum(1 for i in range(12) if j.lookup(f"d{i}")) <= 5
    j.close()


def test_torn_tail_then_append_continues_cleanly(tmp_path):
    """A recovered-then-compacted journal is immediately writable and the
    pre-tear state survives the next generation too."""
    j = RequestJournal(tmp_path)
    j.accept(_req(trace_id="old"))
    j.close()
    (seg,) = _segments(tmp_path)
    seg.write_bytes(seg.read_bytes() + b"deadbeef {torn")  # garbage tail

    j2 = RequestJournal(tmp_path)
    assert j2.torn_records == 1
    rid = j2.accept(_req(trace_id="new"))
    j2.complete(rid, "ok")
    j2.seal()
    j2.close()
    entries, sealed, torn = RequestJournal.read_state(tmp_path)
    assert sealed and torn == 0  # compaction dropped the garbage for good
    assert set(entries) == {"old", "new"}


# -- scheduler integration ---------------------------------------------------


def test_scheduler_journals_full_lifecycle(tmp_path):
    j = RequestJournal(tmp_path)
    sched = MicroBatchScheduler(FakeBackend(), max_batch=4, max_wait_s=0.005,
                                journal=j)
    fut = sched.submit("nội dung " * 10, trace_id="life")
    out = fut.result(timeout=10)
    sched.close()
    (e,) = j.lookup("life")
    assert e.status == "complete" and e.text == out.text
    j.close()


def test_scheduler_journals_engine_failure_typed(tmp_path):
    j = RequestJournal(tmp_path)

    class Exploding(FakeBackend):
        def generate(self, prompts, **kw):
            raise RuntimeError("engine down")

    sched = MicroBatchScheduler(Exploding(), max_batch=4, max_wait_s=0.005,
                                journal=j)
    fut = sched.submit("x " * 5, trace_id="boom")
    with pytest.raises(RuntimeError):
        fut.result(timeout=10)
    sched.close()
    (e,) = j.lookup("boom")
    assert e.status == "failed" and e.reason == "error"
    j.close()


def test_queue_shed_of_admitted_request_is_journaled_failed(tmp_path):
    j = RequestJournal(tmp_path)
    slow = FakeBackend(batch_overhead_s=0.2)
    sched = MicroBatchScheduler(slow, max_batch=1, max_wait_s=0.0, journal=j)
    # head occupies the engine; the second request's deadline expires queued
    f1 = sched.submit("đầu " * 5, trace_id="head")
    f2 = sched.submit("hết hạn " * 5, trace_id="late",
                      deadline=time.monotonic() + 0.05)
    with pytest.raises(RequestShed):
        f2.result(timeout=10)
    f1.result(timeout=10)
    sched.close()
    (e,) = j.lookup("late")
    assert e.status == "failed" and e.reason == "shed:deadline"
    j.close()


def test_admission_shed_is_never_journaled(tmp_path):
    j = RequestJournal(tmp_path)
    slow = FakeBackend(batch_overhead_s=0.2)
    sched = MicroBatchScheduler(slow, max_batch=1, max_wait_s=0.0,
                                max_queue_depth=1, journal=j)
    f1 = sched.submit("a " * 5, trace_id="in")
    time.sleep(0.05)  # f1 is now inside the 0.2s engine dispatch
    f2 = sched.submit("b " * 5, trace_id="queued")  # fills the depth-1 queue
    with pytest.raises(RequestShed):
        # never accepted -> the ledger owes it nothing (the client got a
        # synchronous typed 429; at-least-once starts at ACCEPT)
        sched.submit("c " * 5, trace_id="shed-me")
    f1.result(timeout=10)
    f2.result(timeout=10)
    sched.close()
    j.close()
    entries, _, _ = RequestJournal.read_state(tmp_path)
    assert {"in", "queued"} <= set(entries)
    assert "shed-me" not in entries


# -- restart replay ----------------------------------------------------------


def test_restart_replays_unfinished_byte_identically(tmp_path):
    prompt = "văn bản dang dở cần phát lại " * 6
    # life 1: accept lands in the journal, process "dies" before dispatch
    j = RequestJournal(tmp_path)
    j.accept(_req(prompt=prompt, trace_id="replay-me"))
    j.close()  # crash: no terminal record, no seal

    # life 2: ServeState replays through the normal path
    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005,
                       trace_sample=0.0, journal_dir=str(tmp_path))
    assert state.replay_journal() == 1
    t_end = time.monotonic() + 10
    while state.journal.pending() and time.monotonic() < t_end:
        time.sleep(0.01)
    (e,) = state.journal.lookup("replay-me")
    assert e.status == "complete"
    # byte-identity: the replayed output equals an uninterrupted run's
    assert e.text == FakeBackend().generate([prompt])[0]
    # idempotence at the state level: a second replay enqueues nothing
    assert state.replay_journal() == 0
    state.close()


def test_replay_restores_config_and_expires_stale_deadlines(tmp_path):
    from vnsum_tpu_torch.core.config import GenerationConfig

    j = RequestJournal(tmp_path)
    cfg = GenerationConfig(temperature=0.0, seed=123, top_k=4)
    j.accept(_req(prompt="có cấu hình " * 5, trace_id="cfg",
                  config=cfg))
    j.accept(_req(prompt="đã hết hạn " * 5, trace_id="stale",
                  deadline=time.monotonic() - 1.0))
    j.close()

    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005,
                       trace_sample=0.0, journal_dir=str(tmp_path))
    assert state.replay_journal() == 1  # the stale one fails without enqueue
    (stale,) = state.journal.lookup("stale")
    assert stale.status == "failed" and stale.reason == "shed:deadline"
    t_end = time.monotonic() + 10
    while state.journal.pending() and time.monotonic() < t_end:
        time.sleep(0.01)
    (e,) = state.journal.lookup("cfg")
    assert e.status == "complete"
    state.close()


# -- HTTP surface ------------------------------------------------------------


@pytest.fixture()
def journal_serve(tmp_path):
    state = ServeState(FakeBackend(), max_batch=8, max_wait_s=0.005,
                       trace_sample=0.0, journal_dir=str(tmp_path))
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()
    state.close()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def test_poll_endpoint_serves_journaled_result(journal_serve):
    base, state = journal_serve
    status, d = _post(base + "/v1/generate",
                      {"prompt": "xin chào " * 10, "request_id": "poll-me"})
    assert status == 200
    text = d["completions"][0]["text"]
    status, d = _get(base + "/v1/requests/poll-me")
    assert status == 200
    assert d["status"] == "completed"
    assert d["entries"][0]["text"] == text


def test_poll_unknown_id_is_404(journal_serve):
    base, _ = journal_serve
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base + "/v1/requests/never-seen")
    assert exc.value.code == 404


def test_poll_without_journal_is_404():
    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005,
                       trace_sample=0.0)
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/v1/requests/x")
        assert exc.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        state.close()


def test_journal_metrics_rendered(journal_serve):
    base, state = journal_serve
    _post(base + "/v1/generate", {"prompt": "đo lường " * 8})
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    assert "vnsum_serve_journal_records_total" in text
    assert "vnsum_serve_journal_pending 0" in text


def test_inflight_scheduler_journals_slot_completions(tmp_path):
    j = RequestJournal(tmp_path)
    state = ServeState(
        FakeBackend(segment_words=4), max_batch=4, max_wait_s=0.005,
        trace_sample=0.0, inflight=True,
    )
    # swap the journal in (ServeState builds from journal_dir; here we hand
    # the scheduler one directly to keep the in-flight path isolated)
    state.scheduler.journal = j
    fut = state.scheduler.submit("từng đoạn " * 12, trace_id="slots")
    out = fut.result(timeout=10)
    state.close()
    (e,) = j.lookup("slots")
    assert e.status == "complete" and e.text == out.text
    j.close()


# -- chaos helpers -----------------------------------------------------------


def test_kill_schedule_is_seeded_and_covers_required_kinds():
    a = KillSchedule(seed=7, kills=3)
    b = KillSchedule(seed=7, kills=3)
    assert a.describe() == b.describe()  # replayable from the seed
    kinds = {p.kind for p in a.points}
    assert kinds == {"mid_load", "mid_drain"}
    assert KillSchedule(seed=8, kills=3).describe() != a.describe()


@pytest.mark.parametrize("seed,kills", [(7, 3), (8, 5), (123, 6)])
def test_kill_schedule_draws_as_the_jax_package(seed, kills):
    from vnsum_tpu.testing.chaos import KillSchedule as JaxKillSchedule

    assert (KillSchedule(seed=seed, kills=kills).describe()
            == JaxKillSchedule(seed=seed, kills=kills).describe())


def test_free_port_binds():
    port = free_port()
    assert 0 < port < 65536


def test_encode_lines_are_newline_framed():
    raw = _encode({"e": "accept", "rid": "x", "prompt": "có dấu ư"})
    assert raw.endswith(b"\n") and raw[8:9] == b" "
    assert b"\n" not in raw[:-1]  # one record, one line — framing invariant

# -- inspection CLI (python -m vnsum_tpu_torch.serve.journal) ----------------------


def _sealed_fixture(tmp_path):
    """A sealed journal with one of each fate: a COMPLETE, a typed FAIL,
    and one unfinished ACCEPT (the handoff debt the CLI must surface)."""
    j = RequestJournal(tmp_path)
    done = j.accept(_req(prompt="đã xong " * 4, trace_id="cli-done"))
    j.start(done)
    j.complete(done, "kết quả", 3)
    bad = j.accept(_req(prompt="hỏng " * 4, trace_id="cli-bad"))
    j.fail(bad, "engine:boom", "giả lập")
    j.accept(_req(prompt="dang dở " * 4, trace_id="cli-open"))
    j.seal()
    j.close()


def test_journal_cli_dumps_sealed_fixture(tmp_path, capsys):
    from vnsum_tpu_torch.serve.journal import _main

    _sealed_fixture(tmp_path)
    assert _main([str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sealed"] is True and out["torn_records"] == 0
    assert out["entries"] == 3 and out["live"] == 1 and out["terminal"] == 2
    assert out["by_status"] == {"complete": 1, "failed": 1, "accept": 1}
    (open_,) = out["unfinished_accepts"]
    assert open_["rid"] == "cli-open" and open_["status"] == "accept"
    # the dumped payload is the full replayable ACCEPT record
    assert open_["payload"]["prompt"].startswith("dang dở")
    assert "max_new_tokens" in open_["payload"]


def test_journal_cli_subprocess_and_bad_dir(tmp_path):
    import subprocess
    import sys

    _sealed_fixture(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "vnsum_tpu_torch.serve.journal", str(tmp_path)],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["live"] == 1
    proc = subprocess.run(
        [sys.executable, "-m", "vnsum_tpu_torch.serve.journal",
         str(tmp_path / "missing")],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 2
    # last stderr line: runpy may prepend a sys.modules RuntimeWarning
    err = json.loads(proc.stderr.strip().splitlines()[-1])
    assert "not a directory" in err["error"]



def test_cross_process_handoff_completes_byte_identically(tmp_path):
    """The fleet failover invariant, minus the router: SIGKILL worker A
    mid-flight, read its journal from the outside, re-dispatch every
    unfinished ACCEPT onto an unrelated worker B over plain HTTP, and the
    completions byte-match an uninterrupted run. This is exactly what
    RouterState._handoff does — pinned here as a two-process protocol
    test so a journal/payload schema drift fails loudly."""
    from vnsum_tpu_torch.serve.router import request_body_from_payload
    from vnsum_tpu_torch.testing.chaos import ServerProcess, http_json

    dir_a = tmp_path / "worker-a"
    dir_b = tmp_path / "worker-b"
    a = ServerProcess(free_port(), journal_dir=str(dir_a),
                      extra_args=["--fake-batch-overhead-ms", "3000"])
    a.start()
    prompts = [f"bản tin bị bỏ dở số {i} " * 4 for i in range(3)]
    try:
        a.wait_healthy(60.0)

        def post(i, p):
            try:
                http_json("POST", "127.0.0.1", a.port, "/v1/generate",
                          {"prompt": p, "request_id": f"handoff-{i}",
                           "max_new_tokens": 16}, timeout=30.0)
            # lint-allow[swallowed-exception]: the kill below cuts this connection; the ledger, not the reply, is under test
            except OSError:
                pass

        for i, p in enumerate(prompts):
            threading.Thread(target=post, args=(i, p), daemon=True).start()
        # let the ACCEPTs hit A's journal while the 3s batch overhead
        # keeps every request non-terminal
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            entries, _, _ = RequestJournal.read_state(dir_a)
            if len(entries) == len(prompts):
                break
            time.sleep(0.05)
    finally:
        a.sigkill()  # the crash under test: no drain, no seal

    entries, sealed, _ = RequestJournal.read_state(dir_a)
    assert sealed is False
    unfinished = [e for e in entries.values() if not e.terminal]
    assert len(unfinished) == len(prompts)

    b = ServerProcess(free_port(), journal_dir=str(dir_b))
    b.start()
    try:
        b.wait_healthy(60.0)
        for e in unfinished:
            path, body, headers = request_body_from_payload(e.rid, e.payload)
            assert (path, headers) == ("/v1/generate", {"X-Request-Id": e.rid})
            status, resp = http_json("POST", "127.0.0.1", b.port, path,
                                     body, timeout=30.0)
            assert status == 200, resp
            text = resp["completions"][0]["text"]
            # byte-identity against an uninterrupted in-process run of
            # the SAME journaled payload
            assert text == FakeBackend().generate(
                [e.payload["prompt"]],
                max_new_tokens=e.payload.get("max_new_tokens"),
            )[0]
        b.sigterm()
        assert b.wait_exit(30.0) == 0  # graceful: drain + seal
    finally:
        if b.alive:
            b.sigkill()
    _, sealed_b, _ = RequestJournal.read_state(dir_b)
    assert sealed_b is True


# -- cross-package format: the JAX package's journal and the port's ---------

import dataclasses  # noqa: E402

from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig  # noqa: E402
from vnsum_tpu.serve import journal as jax_journal  # noqa: E402
from vnsum_tpu.serve.queue import ServeRequest as JaxServeRequest  # noqa: E402
from vnsum_tpu_torch.core.config import GenerationConfig  # noqa: E402
from vnsum_tpu_torch.serve import journal as port_journal  # noqa: E402

_RECORDS = [
    {"e": "accept", "rid": "a", "prompt": "tóm tắt văn bản dài ư ơ đ",
     "max_new_tokens": 16, "config": None, "reference": None,
     "cache_hint": "<content>", "trace_id": "a", "deadline_unix": None},
    {"e": "accept", "rid": "b#1", "prompt": "x\n\"y\"\t\\z",
     "max_new_tokens": None,
     "config": {"max_new_tokens": 8, "temperature": 0.7, "top_k": 4,
                "top_p": 0.9, "eos_ids": [1, 2], "seed": 123, "spec_k": 0,
                "spec_ngram": 3},
     "reference": "nguồn", "cache_hint": None, "trace_id": "b",
     "deadline_unix": 1760000000.25, "gang": "b", "gang_phase": "map"},
    {"e": "start", "rid": "a"},
    {"e": "complete", "rid": "a", "text": "kết quả\n🙂", "gen": 7},
    {"e": "failed", "rid": "b#1", "reason": "shed:deadline", "detail": "hết hạn"},
    {"e": "cancelled", "rid": "c", "reason": "disconnect"},
    {"e": "gang", "rid": "b", "members": [["b", "map"], ["b#1", "reduce"]]},
    {"e": "gang", "rid": "b", "partial": True, "reason": "poison"},
    {"e": "seal", "t": 1760000001.5},
]


@pytest.mark.parametrize("i", range(len(_RECORDS)))
def test_encode_bytes_equal_jax(i):
    """One record, one line, the same bytes from either package: the CRC
    frame, the compact separators and the unescaped UTF-8."""
    rec = _RECORDS[i]
    raw = port_journal._encode(rec)
    assert raw == jax_journal._encode(rec)
    assert port_journal._decode(raw[:-1]) == jax_journal._decode(raw[:-1]) == rec


def _drive(mod, req_cls, cfg_cls, directory):
    """The same lifecycle through either package's RequestJournal, without
    the two wall-clock fields (deadlines, the seal stamp), so the segment
    bytes can be compared whole."""
    j = mod.RequestJournal(directory)
    cfg = cfg_cls(temperature=0.0, seed=11, top_k=3, eos_ids=(5, 6))
    rids = [
        j.accept(req_cls(prompt="văn bản một " * 4, trace_id="r",
                         max_new_tokens=16, config=cfg, reference="nguồn",
                         cache_hint="văn bản")),
        j.accept(req_cls(prompt="văn bản hai " * 4, trace_id="r",
                         gang_id="r", gang_phase="map")),
        j.accept(req_cls(prompt="văn bản ba " * 4, trace_id="s")),
        j.accept(req_cls(prompt="văn bản bốn " * 4, trace_id="t")),
        j.accept(req_cls(prompt="dang dở " * 4, trace_id="u")),
    ]
    j.gang("r", [(rids[0], "map"), (rids[1], "map")])
    j.start(rids[0])
    j.complete(rids[0], "kết quả một", 3)
    j.streaming(rids[1])
    j.fail(rids[1], "poison", "hỏng")
    j.gang_partial("r")
    j.cancel(rids[2], "api")
    j.preempt(rids[3])
    j.requeue(rids[3])
    j.close()
    return rids


def _entries_view(entries):
    return {rid: (e.status, e.payload, e.to_dict()) for rid, e in entries.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_written_by_one_package_reads_equally_in_the_other(writer, tmp_path):
    if writer == "jax":
        rids = _drive(jax_journal, JaxServeRequest, JaxGenerationConfig, tmp_path)
    else:
        rids = _drive(port_journal, ServeRequest, GenerationConfig, tmp_path)
    assert rids == ["r", "r#1", "s", "t", "u"]
    pe, ps, pt = port_journal.RequestJournal.read_state(tmp_path)
    je, js, jt = jax_journal.RequestJournal.read_state(tmp_path)
    assert _entries_view(pe) == _entries_view(je)
    assert (ps, pt) == (js, jt) == (False, 0)
    assert [e.status for e in pe.values()] == [
        "complete", "failed", "cancelled", "requeued", "accept"]
    assert pe["r"].payload["config"]["eos_ids"] == [5, 6]
    assert port_journal.RequestJournal.read_gangs(tmp_path) == \
        jax_journal.RequestJournal.read_gangs(tmp_path) == {
            "r": {"members": {"r": "map", "r#1": "map"}, "partial": True}}
    # reopening in the OTHER package compacts and replays the same debt
    other = port_journal if writer == "jax" else jax_journal
    j = other.RequestJournal(tmp_path)
    try:
        assert [e.rid for e in j.take_unfinished()] == ["t", "u"]
        assert other.aggregate_status(j.lookup("r")) == "partial"
    finally:
        j.close()


def test_both_packages_write_the_same_segment_bytes(tmp_path):
    _drive(jax_journal, JaxServeRequest, JaxGenerationConfig, tmp_path / "jax")
    _drive(port_journal, ServeRequest, GenerationConfig, tmp_path / "port")
    jax_segs = sorted((tmp_path / "jax").glob("journal.*.jsonl"))
    port_segs = sorted((tmp_path / "port").glob("journal.*.jsonl"))
    assert [p.name for p in jax_segs] == [p.name for p in port_segs]
    assert [p.read_bytes() for p in jax_segs] == [p.read_bytes() for p in port_segs]
    assert port_segs[0].read_bytes().count(b"\n") == 14  # one line a record


def test_request_payload_equal_jax():
    """The replayable ACCEPT payload of equal requests, field for field and
    in order (the QoS fields are omitted at their defaults in both)."""
    kw = dict(prompt="có cấu hình", max_new_tokens=9, reference="r",
              cache_hint="c", trace_id="p", gang_id="g", gang_phase="reduce")
    pp = port_journal.request_payload(ServeRequest(
        config=GenerationConfig(seed=3, eos_ids=(1,)), **kw))
    jp = jax_journal.request_payload(JaxServeRequest(
        config=JaxGenerationConfig(seed=3, eos_ids=(1,)), **kw))
    assert list(pp.items()) == list(jp.items())
    assert "tenant" not in pp and "tier" not in pp
    assert dataclasses.asdict(GenerationConfig()) == dataclasses.asdict(JaxGenerationConfig())


# -- a real server process, SIGKILLed mid-flight, then restarted --------------


@pytest.mark.parametrize("mode", ["batch", "inflight"])
def test_sigkilled_server_replays_unfinished_byte_identically(mode, tmp_path):
    """The crash under test: requests are journaled and in flight (a 3 s
    engine dispatch holds them non-terminal) when the process is SIGKILLed
    — no drain, no seal. A restart on the same journal replays every
    unfinished ACCEPT before taking traffic; each completes with the text
    an uninterrupted run gives, the poll surface answers it, and a SIGTERM
    then seals the ledger with nothing owed."""
    from vnsum_tpu_torch.testing.chaos import ServerProcess, http_json

    jdir = str(tmp_path / "journal")
    extra = ["--inflight", "--slots", "4"] if mode == "inflight" else []
    slow = (["--fake-segment-overhead-ms", "3000"] if mode == "inflight"
            else ["--fake-batch-overhead-ms", "3000"])
    prompts = [f"bản tin bị bỏ dở số {i} " * 4 for i in range(3)]
    a = ServerProcess(free_port(), journal_dir=jdir, extra_args=[*extra, *slow])
    a.start()
    try:
        a.wait_healthy(60.0)

        def post(i, p):
            try:
                http_json("POST", "127.0.0.1", a.port, "/v1/generate",
                          {"prompt": p, "request_id": f"kill-{i}",
                           "max_new_tokens": 16}, timeout=30.0)
            # lint-allow[swallowed-exception]: the kill below cuts this connection; the ledger, not the reply, is under test
            except OSError:
                pass

        for i, p in enumerate(prompts):
            threading.Thread(target=post, args=(i, p), daemon=True).start()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            entries, _, _ = RequestJournal.read_state(jdir)
            if len(entries) == len(prompts):
                break
            time.sleep(0.05)
    finally:
        a.sigkill()
    entries, sealed, torn = RequestJournal.read_state(jdir)
    assert not sealed and torn == 0
    assert sorted(e.rid for e in entries.values() if not e.terminal) == [
        "kill-0", "kill-1", "kill-2"]

    b = ServerProcess(free_port(), journal_dir=jdir, extra_args=extra)
    b.start()
    try:
        b.wait_healthy(60.0)
        # the uninterrupted run: the same prompts through an in-process
        # server of the same mode over the CLI's fake backend
        ref = ServeState(FakeBackend(segment_words=8), max_batch=8,
                         max_wait_s=0.005, trace_sample=0.0,
                         inflight=mode == "inflight", slots=4)
        try:
            want = {f"kill-{i}": ref.scheduler.submit(p, max_new_tokens=16)
                    .result(timeout=30).text for i, p in enumerate(prompts)}
        finally:
            ref.close()
        got = {}
        deadline = time.monotonic() + 30.0
        while len(got) < len(want) and time.monotonic() < deadline:
            for rid in want:
                status, body = http_json("GET", "127.0.0.1", b.port,
                                         f"/v1/requests/{rid}", timeout=5.0)
                if status == 200 and body["status"] == "completed":
                    got[rid] = body["entries"][0]["text"]
            time.sleep(0.05)
        assert got == want
        conn_status, _ = http_json("GET", "127.0.0.1", b.port, "/readyz")
        assert conn_status == 200
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{b.port}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert "vnsum_serve_journal_replayed_total 3" in text
        assert "vnsum_serve_journal_pending 0" in text
        b.sigterm()
        assert b.wait_exit(30.0) == 0  # graceful: drain + seal
    finally:
        if b.alive:
            b.sigkill()
    entries, sealed, torn = RequestJournal.read_state(jdir)
    assert sealed and torn == 0
    assert all(e.status == "complete" for e in entries.values())
