"""SSE streaming (serve/stream.py + the /v1/* stream surface): delta
byte-identity against the non-streaming reply, staggered in-flight joins,
the one-shot single-delta fallback, summarize progress events, and the
stream metrics rows."""
from __future__ import annotations

import http.client
import json
import threading
import urllib.parse
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import StreamChannel
from vnsum_tpu_torch.serve.server import ServeState, make_server

DOC = "\n\n".join(
    f"Đoạn văn {i}: " + "nội dung tiếng Việt có dấu thanh. " * 25
    for i in range(4)
)


# -- channel unit behavior ----------------------------------------------------


def test_channel_emits_monotone_suffix_deltas():
    ch = StreamChannel("r1")
    assert ch.push_text("mot")
    assert not ch.push_text("mot")          # not extending: nothing leaves
    assert ch.push_text("mot hai")
    assert not ch.push_text("khac hoan toan")  # regression (preempt restart)
    assert not ch.push_text("mot")             # still behind the high-water
    assert ch.push_text("mot hai ba")          # re-passed the mark: resumes
    deltas = []
    while not ch.empty():
        ev = ch.pop(0.01)
        if ev and ev[0] == "delta":
            deltas.append(ev[1]["text"])
    assert "".join(deltas) == "mot hai ba"


def test_channel_coalesces_on_full_preserving_identity():
    """A slow consumer's pending deltas collapse into fewer events when the
    bounded channel fills — and the concatenation identity survives,
    because adjacent deltas concatenate in order."""
    ch = StreamChannel("r2", maxsize=4)
    final = ""
    for i in range(64):
        final += f"tu{i} "
        ch.push_text(final)
    assert ch.coalesced > 0
    deltas = []
    while not ch.empty():
        ev = ch.pop(0.01)
        if ev and ev[0] == "delta":
            deltas.append(ev[1]["text"])
    assert len(deltas) < 64  # actually coalesced
    assert "".join(deltas) == final


def test_channel_coalesce_keeps_latest_progress_and_interleaves():
    ch = StreamChannel("r3", maxsize=4)
    ch.push_text("a")
    for n in range(1, 30):
        ch.push_event("progress", {"llm_requests_done": n})
    ch.push_text("ab")
    events = []
    while not ch.empty():
        events.append(ch.pop(0.01))
    kinds = [e[0] for e in events]
    assert kinds.count("progress") < 29  # progress runs collapsed
    last_progress = [e for e in events if e[0] == "progress"][-1]
    assert last_progress[1]["llm_requests_done"] == 29  # latest survives
    assert "".join(e[1]["text"] for e in events if e[0] == "delta") == "ab"


def test_channel_bound_holds_under_alternating_kinds():
    """Pathological alternation (delta/progress/delta/...) defeats
    adjacent-run merging; the global collapse must still hold the hard
    bound (at most one event per kind) AND the concatenation identity."""
    ch = StreamChannel("r8", maxsize=6)
    final = ""
    for i in range(100):
        final += f"t{i} "
        ch.push_text(final)
        ch.push_event("progress", {"llm_requests_done": i})
    # bounded despite never popping: the whole backlog is a handful of
    # events, not 200
    assert len(ch._q) < 6
    events = []
    while not ch.empty():
        events.append(ch.pop(0.01))
    assert "".join(p["text"] for n, p, _s in events if n == "delta") == final
    assert max(
        p["llm_requests_done"] for n, p, _s in events if n == "progress"
    ) == 99


def test_channel_detach_supersedes_stale_consumer():
    from vnsum_tpu_torch.serve import StreamDetached

    ch = StreamChannel("r4")
    gen1 = ch.attach()
    ch.push_text("mot")
    assert ch.pop(0.01, gen1)[0] == "delta"
    gen2 = ch.attach()
    with pytest.raises(StreamDetached):
        ch.pop(0.01, gen1)  # the stale consumer must stand down
    ch.push_text("mot hai")
    assert ch.pop(0.01, gen2)[1]["text"] == " hai"


def test_channel_resume_snapshot_folds_buffered_deltas():
    ch = StreamChannel("r5")
    ch.push_text("mot")
    ch.push_text("mot hai")          # both deltas still buffered
    ch.push_event("progress", {"llm_requests_done": 1})
    text, seq = ch.resume_snapshot()
    assert text == "mot hai" and seq >= 2
    # buffered deltas are gone (their bytes live in the snapshot); the
    # progress event survived
    ev = ch.pop(0.01)
    assert ev[0] == "progress"
    assert ch.empty()
    ch.push_text("mot hai ba")
    assert text + ch.pop(0.01)[1]["text"] == "mot hai ba"


def test_channel_concatenation_identity_under_concurrent_churn():
    """Randomized producer/consumer race over a tiny bounded channel, with
    preemption-style regressions, mid-stream coalescing, and one resume:
    snapshot + collected deltas must reassemble the exact final text."""
    import random

    rng = random.Random(13)
    words = [f"tu{i}" for i in range(400)]
    final = " ".join(words)
    ch = StreamChannel("r6", maxsize=8)
    collected: list[str] = []
    stop = threading.Event()

    def consumer():
        while not stop.is_set() or not ch.empty():
            ev = ch.pop(0.002)
            if ev and ev[0] == "delta":
                collected.append(ev[1]["text"])
            if rng.random() < 0.05:
                import time as _t
                _t.sleep(0.003)  # slow consumer: force coalescing

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    upto = 0
    while upto < len(words):
        upto += rng.randint(1, 7)
        snapshot = " ".join(words[: min(upto, len(words))])
        ch.push_text(snapshot)
        if rng.random() < 0.2:
            # preemption restart: a non-extending snapshot emits nothing
            ch.push_text(" ".join(words[: max(upto // 2, 1)]))
    ch.push_text(final)
    stop.set()
    t.join(timeout=30)
    assert "".join(collected) == final


def test_channel_resume_snapshot_identity_with_consumer_gap():
    """Disconnect-shaped sequence: consume a prefix, drop events on the
    floor (the dead socket), resume via snapshot, drain the rest — the
    reassembled text is exact."""
    import random

    rng = random.Random(29)
    words = [f"w{i}" for i in range(200)]
    final = " ".join(words)
    ch = StreamChannel("r7", maxsize=8)
    got: list[str] = []
    # phase 1: live consumption of a random prefix of pushes
    upto = 0
    while upto < 80:
        upto += rng.randint(1, 9)
        ch.push_text(" ".join(words[:upto]))
        if rng.random() < 0.7:
            ev = ch.pop(0.001)
            if ev and ev[0] == "delta":
                got.append(ev[1]["text"])
    prefix = "".join(got)
    # phase 2: disconnected — more pushes pile up (and coalesce)
    while upto < len(words):
        upto += rng.randint(1, 9)
        ch.push_text(" ".join(words[: min(upto, len(words))]))
    ch.push_text(final)
    # phase 3: resume — the snapshot replaces everything buffered
    text, _seq = ch.resume_snapshot()
    assert text.startswith(prefix)
    rest: list[str] = []
    while not ch.empty():
        ev = ch.pop(0.001)
        if ev and ev[0] == "delta":
            rest.append(ev[1]["text"])
    assert text + "".join(rest) == final


# -- SSE over HTTP ------------------------------------------------------------


def sse_post(base, path, payload, headers=None):
    """POST and parse the whole SSE response into [(event, payload)]."""
    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        body = json.dumps(payload)
        conn.request("POST", path, body=body, headers={
            "Content-Type": "application/json", **(headers or {}),
        })
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        assert resp.getheader("Content-Type", "").startswith(
            "text/event-stream"
        )
        raw = resp.read().decode()
    finally:
        conn.close()
    events = []
    for frame in raw.split("\n\n"):
        if not frame.strip():
            continue
        name = data = None
        for line in frame.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        events.append((name, data))
    return events


def deltas_of(events):
    return "".join(p["text"] for n, p in events if n == "delta")


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture()
def inflight_server():
    state = ServeState(
        FakeBackend(segment_words=4, segment_overhead_s=0.002,
                    batch_overhead_s=0.005),
        max_batch=4, max_wait_s=0.005, inflight=True, slots=4,
    )
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()
    state.close()


def test_streamed_generate_is_byte_identical_to_nonstreaming(inflight_server):
    base, _ = inflight_server
    prompt = "tom tat van ban tieng viet nay " * 8
    _, plain = _post(base + "/v1/generate", {"prompt": prompt})
    events = sse_post(base, "/v1/generate",
                      {"prompt": prompt, "stream": True})
    assert events[-1][0] == "done"
    done = events[-1][1]
    text = done["completions"][0]["text"]
    # the headline invariant: concatenated deltas == the final text == the
    # non-streaming reply for the same request
    assert deltas_of(events) == text
    assert text == plain["completions"][0]["text"]
    # several segment-boundary deltas, not one blob at the end
    assert sum(1 for n, _ in events if n == "delta") > 1
    assert done["completions"][0]["record"]["status"] == "ok"
    assert done["request_id"]


def test_streamed_deltas_under_staggered_joins(inflight_server):
    """Concurrent streams joining a running batch at different segments:
    every stream's deltas must reassemble ITS own text (no cross-slot
    bleed), byte-identical to a solo run."""
    base, _ = inflight_server
    prompts = [f"tai lieu so {i} rieng biet noi dung " * (4 + 2 * i)
               for i in range(4)]
    results: list = [None] * len(prompts)

    def worker(i):
        # staggered: each joiner arrives a few segments into the others
        import time
        time.sleep(0.004 * i)
        results[i] = sse_post(base, "/v1/generate",
                              {"prompt": prompts[i], "stream": True})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, events in enumerate(results):
        expect = FakeBackend().generate([prompts[i]])[0]
        assert events[-1][0] == "done"
        assert deltas_of(events) == expect, f"stream {i} corrupted"


def test_streamed_deltas_at_fused_cadence_reassemble_exactly():
    """--fused-segments 4 coarsens delta pushes to one per host dispatch
    (the coalesced boundary fetch) — the reassembled stream must still be
    byte-identical to the non-streaming reply for the same prompt."""
    state = ServeState(
        FakeBackend(segment_words=4, segment_overhead_s=0.002,
                    batch_overhead_s=0.005),
        max_batch=4, max_wait_s=0.005, inflight=True, slots=4,
        fused_segments=4,
    )
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        prompt = "dong chay hop nhat bon phan doan mot luot " * 8
        events = sse_post(base, "/v1/generate",
                          {"prompt": prompt, "stream": True})
        assert events[-1][0] == "done"
        text = events[-1][1]["completions"][0]["text"]
        assert deltas_of(events) == text
        assert text == FakeBackend().generate([prompt])[0]
        snap = state.scheduler.metrics.snapshot()
        assert snap.fused_dispatches > 0
        assert snap.segments >= snap.fused_dispatches
    finally:
        server.shutdown()
        server.server_close()
        state.close()


def test_streamed_generate_on_batch_scheduler_single_final_delta():
    """The one-shot dispatch path has no observable mid-decode boundary:
    streaming degrades to one delta carrying the whole text, and the
    identity invariant still holds."""
    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005)
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        prompt = "duong mot lan " * 6
        events = sse_post(base, "/v1/generate",
                          {"prompt": prompt, "stream": True})
        assert [n for n, _ in events] == ["delta", "done"]
        assert deltas_of(events) == events[-1][1]["completions"][0]["text"]
    finally:
        server.shutdown()
        server.server_close()
        state.close()


def test_stream_rejects_multi_prompt(inflight_server):
    base, _ = inflight_server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/generate",
              {"prompts": ["mot", "hai"], "stream": True})
    assert exc.value.code == 400


def test_stream_admission_shed_is_plain_429(inflight_server):
    # sheds decided BEFORE the stream opens answer as typed JSON, not SSE
    base, _ = inflight_server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/generate",
              {"prompt": "tre han", "deadline_ms": 0, "stream": True})
    assert exc.value.code == 429
    assert json.loads(exc.value.read())["reason"] == "deadline"


def test_streamed_summarize_progress_and_done_payload(inflight_server):
    base, _ = inflight_server
    _, plain = _post(base + "/v1/summarize",
                     {"text": DOC, "approach": "mapreduce"})
    events = sse_post(base, "/v1/summarize",
                      {"text": DOC, "approach": "mapreduce", "stream": True})
    names = [n for n, _ in events]
    assert names[-1] == "done" and "progress" in names
    done = events[-1][1]
    # the done event is the non-streaming reply, summary byte-identical
    assert done["summary"] == plain["summary"]
    assert done["approach"] == "mapreduce"
    assert done["serving"]["llm_requests"] == done["llm_calls"]
    # progress counted up to the full fan-out
    last_progress = [p for n, p in events if n == "progress"][-1]
    assert last_progress["llm_requests_done"] == done["llm_calls"]


def test_stream_lifecycle_and_metrics(inflight_server):
    base, state = inflight_server
    sse_post(base, "/v1/generate",
             {"prompt": "do luong luong su kien " * 6, "stream": True})
    snap = state.scheduler.metrics.snapshot()
    assert snap.stream_requests >= 1
    assert snap.stream_events >= 2  # deltas + done
    assert snap.streams_open == 0   # gauge returns to zero after close
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    assert "vnsum_serve_stream_requests_total" in text
    assert "vnsum_serve_stream_events_total" in text
    assert "vnsum_serve_stream_active 0" in text

