"""In-flight scheduler over the FakeBackend slot loop: slot feeding,
refill into a running batch, key switching, oversized fallback, deadline
shedding, drain on close, take_upto semantics, and the slot metrics
surface. Hermetic — the real-engine loop is covered by
tests/test_inflight_engine.py."""
from __future__ import annotations

import threading
import time

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.serve import (
    InflightScheduler,
    RequestQueue,
    RequestShed,
    ServeRequest,
    ShedReason,
)


def make_backend(**kw):
    kw.setdefault("segment_words", 8)
    kw.setdefault("segment_overhead_s", 0.005)
    kw.setdefault("per_slot_segment_s", 0.0005)
    kw.setdefault("batch_overhead_s", 0.01)
    return FakeBackend(**kw)


def make_sched(backend=None, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_wait_s", 0.01)
    return InflightScheduler(backend or make_backend(), **kw)


# -- basic serving -----------------------------------------------------------


def test_requests_complete_with_correct_per_request_outputs():
    sched = make_sched()
    try:
        prompts = [f"tai lieu {i} noi dung rieng " * 6 for i in range(8)]
        futs = [sched.submit(p) for p in prompts]
        for p, f in zip(prompts, futs):
            c = f.result(timeout=30)
            assert c.text == FakeBackend().generate([p])[0]
            assert c.record.status == "ok"
            # TTFT is anchored at the joiner's own prefill, always — the
            # slot loop needs no tracing collector for the anchor
            assert c.record.ttft_anchored
            assert 0 <= c.record.ttft_s <= c.record.total_s
        snap = sched.metrics.snapshot()
        assert snap.completed == 8
        assert snap.segments > 0
    finally:
        sched.close()


def test_inflight_concurrent_submissions():
    """Concurrent submitters stream through shared slots (also rerun under
    VNSUM_SANITIZERS=all in CI — the lock-order/transfer detectors cover
    the queue/metrics/loop interplay)."""
    sched = make_sched()
    try:
        prompts = [f"dong thoi {i} " * (4 + i) for i in range(10)]
        results = [None] * len(prompts)
        barrier = threading.Barrier(len(prompts))

        def worker(i, p):
            barrier.wait()
            results[i] = sched.submit(p).result(timeout=30)

        threads = [
            threading.Thread(target=worker, args=(i, p))
            for i, p in enumerate(prompts)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for p, c in zip(prompts, results):
            assert c.text == FakeBackend().generate([p])[0]
    finally:
        sched.close()


def test_refill_joins_running_batch():
    """A long-running resident plus later short arrivals: the later ones
    must be admitted at a segment boundary WHILE the resident decodes
    (refills counter moves), not after it finishes."""
    backend = make_backend(segment_words=4)  # 40-word output = 10 segments
    sched = make_sched(backend)
    try:
        long_fut = sched.submit("dai " * 60)
        time.sleep(0.03)  # a few segments deep
        short_futs = [sched.submit(f"ngan {i} muoi tu " * 3) for i in range(3)]
        long_c = long_fut.result(timeout=30)
        short_cs = [f.result(timeout=30) for f in short_futs]
        snap = sched.metrics.snapshot()
        assert snap.refills >= 3, snap.refills
        # the joiners rode the resident's batch: occupancy above 1
        assert any(c.record.batch_size > 1 for c in short_cs)
        assert long_c.record.status == "ok"
    finally:
        sched.close()


def test_short_joiner_finishes_before_long_resident():
    """The whole point of in-flight batching: a short request admitted
    during a long decode completes without waiting the stranger out."""
    backend = make_backend(segment_words=4)
    sched = make_sched(backend)
    try:
        long_fut = sched.submit("rat dai " * 60)           # 10 segments
        time.sleep(0.02)
        t0 = time.monotonic()
        short_c = sched.submit("ngan gon").result(timeout=30)
        short_wall = time.monotonic() - t0
        long_c = long_fut.result(timeout=30)
        assert long_c.record.total_s > short_wall
        assert short_c.record.status == "ok"
    finally:
        sched.close()


# -- compatibility / key switching -------------------------------------------


def test_incompatible_keys_drain_and_switch():
    sched = make_sched()
    try:
        a = sched.submit("khoa mot " * 5, max_new_tokens=16)
        b = sched.submit("khoa hai " * 5, max_new_tokens=32)
        c = sched.submit(
            "khoa ba " * 5, config=GenerationConfig(temperature=0.5)
        )
        for f in (a, b, c):
            assert f.result(timeout=30).record.status == "ok"
    finally:
        sched.close()


def test_incompatible_head_is_not_starved():
    """Compatible traffic keeps arriving while an incompatible request
    waits: after switch_grace_s the loop must drain and serve it."""
    backend = make_backend()
    sched = make_sched(backend, switch_grace_s=0.05)
    try:
        sched.submit("nen " * 30).result(timeout=30)  # warm the loop's key
        stop = threading.Event()
        done_odd = []

        def odd_key():
            done_odd.append(
                sched.submit("khac khoa " * 5, max_new_tokens=16)
                .result(timeout=30)
            )

        t = threading.Thread(target=odd_key)
        t.start()

        def feeder():
            while not stop.is_set():
                sched.submit("cung khoa " * 10).result(timeout=30)

        feeders = [threading.Thread(target=feeder) for _ in range(2)]
        for f in feeders:
            f.start()
        t.join(timeout=20)
        stop.set()
        for f in feeders:
            f.join(timeout=20)
        assert done_odd and done_odd[0].record.status == "ok"
    finally:
        sched.close()


# -- oversized fallback ------------------------------------------------------


def test_oversized_prompt_falls_back_to_batch_dispatch():
    backend = make_backend()
    sched = make_sched(backend, slot_prompt_tokens=8)
    try:
        small = sched.submit("vua khit day")           # 3 words, fits
        big_prompt = "qua kho " * 20                   # 40 words > 8
        big = sched.submit(big_prompt)
        assert small.result(timeout=30).record.status == "ok"
        c = big.result(timeout=30)
        assert c.record.status == "ok"
        assert c.text == FakeBackend().generate([big_prompt])[0]
    finally:
        sched.close()


# -- shedding / shutdown -----------------------------------------------------


def test_deadline_expiring_in_queue_is_shed():
    backend = make_backend(segment_words=2, segment_overhead_s=0.03)
    sched = make_sched(backend, slots=1)
    try:
        slow = sched.submit("giu may " * 40)  # 20 segments x 30ms
        shed = sched.submit(
            "het han " * 5, deadline=time.monotonic() + 0.05
        )
        assert slow.result(timeout=30).record.status == "ok"
        with pytest.raises(RequestShed) as exc:
            shed.result(timeout=30)
        assert exc.value.reason is ShedReason.DEADLINE
    finally:
        sched.close()


def test_close_drains_resident_and_queued():
    backend = make_backend()
    sched = make_sched(backend)
    futs = [sched.submit(f"thoat {i} " * 6) for i in range(6)]
    sched.close(drain=True)
    for f in futs:
        assert f.result(timeout=1).record.status == "ok"
    assert not sched._thread.is_alive()
    with pytest.raises(RequestShed):
        sched.submit("den muon ")


def test_backend_without_slot_loop_is_rejected():
    class NoLoop(FakeBackend):
        start_slot_loop = None

    with pytest.raises(ValueError, match="start_slot_loop"):
        InflightScheduler(NoLoop())


# -- strategy fan-out rides the slots ----------------------------------------


def test_queued_backend_fanout_rides_slot_loop():
    sched = make_sched()
    try:
        qb = sched.backend_view()
        outs = qb.generate([f"chunk {i} cua tai lieu " * 4 for i in range(6)])
        ref = FakeBackend()
        assert outs == [
            ref.generate([f"chunk {i} cua tai lieu " * 4])[0]
            for i in range(6)
        ]
        assert sched.metrics.snapshot().segments > 0
    finally:
        sched.close()


# -- fused multi-step decode (--fused-segments) ------------------------------


def test_fused_scheduler_outputs_and_dispatch_counters():
    """--fused-segments 4: outputs stay byte-identical to an unfused run
    (same per-row math, coarser host cadence) and the counters expose the
    amortization — more segments retired than host dispatches (also rerun
    under VNSUM_SANITIZERS=all in CI: the transfer guard proves the fused
    boundary fetch is the only device sync)."""
    backend = make_backend(segment_words=4)
    sched = make_sched(backend, fused_segments=4)
    try:
        prompts = [f"tai lieu hop nhat {i} noi dung rieng " * 8
                   for i in range(6)]
        futs = [sched.submit(p) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=30).text == FakeBackend().generate([p])[0]
        snap = sched.metrics.snapshot()
        assert snap.completed == 6
        assert snap.fused_dispatches > 0
        assert snap.segments > snap.fused_dispatches
        text = sched.metrics.render_prometheus(
            queue_depth=0, queued_tokens=0, slot_state=sched.slot_state()
        )
    finally:
        sched.close()
    assert "vnsum_serve_inflight_fused_dispatches_total" in text
    assert "vnsum_serve_inflight_fused_segments_bucket" in text


def test_fused_refill_joins_at_dispatch_boundaries():
    """Joins coarsen to fused-dispatch cadence but still land WHILE the
    resident decodes — the refill counter moves before the long request
    finishes, exactly as at N=1."""
    backend = make_backend(segment_words=4, per_step_s=0.002)
    sched = make_sched(backend, fused_segments=2)
    try:
        long_fut = sched.submit("dai " * 60)
        time.sleep(0.04)  # a fused dispatch or two deep
        short_futs = [sched.submit(f"ngan {i} muoi tu " * 3)
                      for i in range(3)]
        long_c = long_fut.result(timeout=30)
        short_cs = [f.result(timeout=30) for f in short_futs]
        snap = sched.metrics.snapshot()
        assert snap.refills >= 2, snap.refills
        assert any(c.record.batch_size > 1 for c in short_cs)
        assert long_c.record.status == "ok"
        assert snap.fused_dispatches > 0
    finally:
        sched.close()


# -- take_upto unit behavior -------------------------------------------------


def test_take_upto_filters_by_key_and_bills_per_slot():
    q = RequestQueue(max_depth=8, max_queued_tokens=1000)
    a = ServeRequest(prompt="a mot hai", max_new_tokens=32, est_tokens=3)
    b = ServeRequest(prompt="b ba", max_new_tokens=64, est_tokens=2)
    c = ServeRequest(prompt="c bon nam", max_new_tokens=32, est_tokens=3)
    for r in (a, b, c):
        q.submit(r)
    assert q.queued_tokens == 8
    got = q.take_upto(4, key=(32, None))
    assert [r.prompt for r in got] == ["a mot hai", "c bon nam"]
    assert q.depth == 1 and q.queued_tokens == 2
    # head-key default
    assert [r.prompt for r in q.take_upto(1)] == ["b ba"]
    # empty + open: [] after the wait; closed + drained: None
    assert q.take_upto(1, wait_s=0.0) == []
    q.close()
    assert q.take_upto(1) is None


def test_take_upto_head_snapshot():
    q = RequestQueue(max_depth=4)
    assert q.head_snapshot() is None
    r = ServeRequest(prompt="x", max_new_tokens=16)
    q.submit(r)
    key, enq = q.head_snapshot()
    assert key == (16, None) and enq == r.enqueued_at


# -- metrics surface ---------------------------------------------------------


def test_slot_metrics_render():
    sched = make_sched()
    try:
        sched.submit("do luong " * 6).result(timeout=30)
        text = sched.metrics.render_prometheus(
            queue_depth=0, queued_tokens=0, slot_state=sched.slot_state()
        )
    finally:
        sched.close()
    assert "vnsum_serve_inflight_segments_total" in text
    assert "vnsum_serve_inflight_refills_total" in text
    assert "vnsum_serve_slots_total 4" in text
    assert "vnsum_serve_slots_busy" in text
    assert "vnsum_serve_slot_occupancy_bucket" in text
    assert "vnsum_serve_ttft_seconds_bucket" in text
