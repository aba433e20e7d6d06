"""Watchdog acceptance on the port's serving layer (tests/test_serve_watchdog.py
without the journal): hang/stall detection math under a synthetic clock,
false-positive immunity for slow-but-progressing dispatches, wedged-dispatch
recovery (one-shot riders typed HUNG; slot-loop teardown + requeue with
byte-identical rebuilt outputs), close() racing that recovery, helper
escalation, the drain-beats-sleep fix, and the /debug/stacks + /healthz
surfaces.
Everything hermetic (FakeBackend + the fault plan's `hang` kind); the
cardinal assertion, as everywhere in serve/: EVERY future resolves."""
from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import (
    FailureClass,
    InflightScheduler,
    MicroBatchScheduler,
    RequestFailed,
    Watchdog,
)
from vnsum_tpu_torch.serve.supervisor import EngineSupervisor, RetryPolicy
from vnsum_tpu_torch.serve.watchdog import Stall, snapshot_stacks
from vnsum_tpu_torch.testing.faults import FaultPlan, FaultSpec, injected

FAST = RetryPolicy(max_attempts=2, backoff_base_s=0.005, backoff_max_s=0.02,
                   jitter=0.0)


def _wait_until(cond, timeout_s: float = 5.0) -> None:
    """Poll a racy cross-thread counter: the recovery hook resolves the
    riders BEFORE the watchdog thread increments its own bookkeeping, so a
    test that just unblocked on a future may read the counter early."""
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- detection math (synthetic clock, no threads, no sleeps) -----------------


def test_heartbeat_stall_detection_and_classification():
    clock = FakeClock()
    wd = Watchdog(loop_deadline_s=5.0, helper_deadline_s=20.0, clock=clock)
    loop_hb = wd.register("loop-thread", kind="loop")
    helper_hb = wd.register("helper-thread", kind="helper")
    assert wd.check() == []
    clock.advance(4.9)
    assert wd.check() == []  # inside every deadline
    clock.advance(0.2)  # loop 5.1s quiet, helper well inside 20s
    stalls = wd.check()
    assert [(s.kind, s.name) for s in stalls] == [("lock", "loop-thread")]
    assert stalls[0].stalled_for_s == pytest.approx(5.1)
    assert stalls[0].limit_s == 5.0
    # flagged once: the same wedge does not re-fire every interval
    assert wd.check() == []
    # beating clears the flag; a NEW stall fires again
    loop_hb.beat()
    assert wd.check() == []
    clock.advance(5.5)
    assert [(s.kind, s.name) for s in wd.check()] == [
        ("lock", "loop-thread")
    ]
    # the helper finally goes quiet past ITS deadline -> helper-classified
    helper_hb.beat()
    clock.advance(20.1)
    kinds = {(s.kind, s.name) for s in wd.check()}
    assert ("helper", "helper-thread") in kinds


def test_dispatch_budget_math_and_false_positive_immunity():
    clock = FakeClock()
    wd = Watchdog(loop_deadline_s=2.0, dispatch_base_s=10.0,
                  dispatch_per_token_s=0.01, clock=clock)
    wd.register("scheduler", kind="loop")
    # budget scales with token work: 10s base + 0.01 * 2000 = 30s
    assert wd.dispatch_budget(2000) == pytest.approx(30.0)
    t = wd.begin_dispatch("scheduler", "one_shot", wd.dispatch_budget(2000),
                          riders=("req-1",), tokens=2000)
    # a SLOW dispatch inside its budget is never a stall, even when the
    # loop heartbeat is long past its own deadline (it cannot beat while
    # dispatching — the ticket suspends the heartbeat check)
    clock.advance(29.0)
    assert wd.check() == []
    wd.end_dispatch(t)
    # after a clean end the heartbeat check resumes (and the loop IS stale
    # now — it has not beaten in 29s); that reads as a lock stall, which is
    # correct: nothing is dispatching and the thread went quiet
    stalls = wd.check()
    assert [s.kind for s in stalls] == ["lock"]


def test_dispatch_past_budget_is_hung_and_fires_once():
    clock = FakeClock()
    wd = Watchdog(loop_deadline_s=100.0, dispatch_base_s=5.0,
                  dispatch_per_token_s=0.0, clock=clock)
    wd.register("scheduler", kind="loop")
    ticket = wd.begin_dispatch("scheduler", "one_shot", 5.0,
                               riders=("req-9",), tokens=64)
    clock.advance(5.2)
    stalls = wd.check()
    assert [(s.kind, s.name) for s in stalls] == [("dispatch", "scheduler")]
    assert stalls[0].ticket is ticket
    assert stalls[0].detail["riders"] == ["req-9"]
    # the hung ticket was consumed: no re-fire, and the abandoned thread's
    # late end_dispatch is a harmless no-op
    assert wd.check() == []
    wd.end_dispatch(ticket)
    assert wd.check() == []


def test_fused_segment_budget_math_and_false_positive_immunity():
    """--fused-segments N holds the host for up to N on-device segments
    per ticket: the slot_segment budget scales by N (a fused dispatch
    inside it is never a stall) and a dispatch past the SCALED budget
    still trips as a real HUNG."""
    clock = FakeClock()
    wd = Watchdog(loop_deadline_s=100.0, segment_budget_s=2.0, clock=clock)
    wd.register("scheduler", kind="loop")
    assert wd.segment_budget() == pytest.approx(2.0)
    assert wd.segment_budget(4) == pytest.approx(8.0)
    t = wd.begin_dispatch("scheduler", "slot_segment", wd.segment_budget(4))
    clock.advance(7.5)  # would be HUNG at N=1; inside the N=4 budget
    assert wd.check() == []
    wd.end_dispatch(t)
    t2 = wd.begin_dispatch("scheduler", "slot_segment", wd.segment_budget(4))
    clock.advance(8.2)  # past even the scaled budget -> real hang
    stalls = wd.check()
    assert [(s.kind, s.name) for s in stalls] == [("dispatch", "scheduler")]
    assert stalls[0].ticket is t2
    wd.end_dispatch(t2)


def test_unregister_stops_monitoring():
    clock = FakeClock()
    wd = Watchdog(loop_deadline_s=1.0, clock=clock)
    wd.register("scheduler", kind="loop")
    wd.unregister("scheduler")  # clean drain: not a stall
    clock.advance(60.0)
    assert wd.check() == []


# -- stall handling: dumps, stacks, counters ---------------------------------


def test_stall_dump_carries_thread_stacks(tmp_path):
    wd = Watchdog(loop_deadline_s=1.0, dump_dir=tmp_path)
    stall = Stall(kind="lock", name="scheduler", stalled_for_s=3.0,
                  limit_s=1.0)
    wd.handle(stall)
    dumps = list(tmp_path.glob("watchdog_lock_*.json"))
    assert len(dumps) == 1
    d = json.loads(dumps[0].read_text())
    assert d["stall"]["thread"] == "scheduler"
    assert d["stall"]["stalled_for_s"] == 3.0
    # the snapshot must contain THIS thread with a real Python stack
    me = threading.current_thread().name
    names = {t["name"] for t in d["stacks"]}
    assert me in names
    mine = next(t for t in d["stacks"] if t["name"] == me)
    assert any("test_stall_dump_carries_thread_stacks" in ln
               for ln in mine["stack"])
    assert wd.stalls_total["lock"] == 1
    assert wd.last_stall["kind"] == "lock"


def test_snapshot_stacks_sees_a_parked_thread():
    release = threading.Event()

    def parked():
        release.wait(timeout=30)  # the wedge under observation

    t = threading.Thread(target=parked, name="parked-for-test", daemon=True)
    t.start()
    time.sleep(0.05)
    try:
        stacks = snapshot_stacks()
        park = next(s for s in stacks if s["name"] == "parked-for-test")
        assert any("parked" in ln for ln in park["stack"])
    finally:
        release.set()


# -- recovery: hung one-shot dispatch ----------------------------------------


def test_hung_oneshot_riders_resolve_typed_and_scheduler_recovers():
    wd = Watchdog(interval_s=0.03, loop_deadline_s=5.0, dispatch_base_s=0.25,
                  dispatch_per_token_s=0.0)
    wd.start()
    sup = EngineSupervisor(FAST, resource_strikes_per_step=1)
    backend = FakeBackend()
    sched = MicroBatchScheduler(backend, max_batch=4, max_wait_s=0.01,
                                supervisor=sup, watchdog=wd)
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="hang",
                                on_call=1, delay_s=0.0)])
    try:
        with injected(plan):
            fut = sched.submit("treo may mot hai ba bon")
            with pytest.raises(RequestFailed) as exc:
                fut.result(timeout=10)
            assert exc.value.failure_class is FailureClass.HUNG
            # the replacement thread serves new work (the hang is spent)
            fut2 = sched.submit("<content>\nphuc hoi ngay sau do\n</content>")
            assert "phuc hoi" in fut2.result(timeout=10).text
        assert wd.stalls_total["dispatch"] == 1
        assert wd.hung_dispatches_total == 1
        _wait_until(lambda: wd.recoveries_total == 1)
        # the ladder took the resource strike (strikes_per_step=1)
        assert int(sup.rung) >= 1
        # typed HUNG is a counted failure class
        assert sched.metrics.snapshot().failures.get("hung") == 1
    finally:
        plan.release_hangs()
        sched.close(timeout=5)
        wd.close()


@pytest.mark.parametrize("round_", range(4))
def test_hung_dispatch_fails_typed_and_close_races_recovery(round_):
    """Riders of a hung dispatch fail typed HUNG, and a close() issued the
    moment they do (while recovery may still hold its fenced, unstarted
    successor thread) returns cleanly: it waits for the start instead of
    joining a thread that never started. Repeated: the window is a race."""
    wd = Watchdog(interval_s=0.03, loop_deadline_s=5.0, dispatch_base_s=0.25,
                  dispatch_per_token_s=0.0)
    wd.start()
    sched = MicroBatchScheduler(FakeBackend(), max_batch=2, max_wait_s=0.01,
                                watchdog=wd)
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="hang",
                                on_call=1, delay_s=0.0)])
    try:
        with injected(plan):
            fut = sched.submit("ket trong dong co", trace_id=f"hung-{round_}")
            with pytest.raises(RequestFailed) as exc:
                fut.result(timeout=10)
            assert exc.value.failure_class is FailureClass.HUNG
            sched.close(timeout=5)
        assert sched.metrics.snapshot().errors == 1
        assert not sched._thread.is_alive()
    finally:
        plan.release_hangs()
        sched.close(timeout=5)
        wd.close()


def test_close_waits_for_a_fenced_successor_thread():
    """The race close() repairs, made deterministic: recovery has installed
    an unstarted successor (``_fence_replacement``) when close() runs, and
    starts it (``_start_replacement``) only later. close() must neither
    raise nor return before that thread has started and drained."""
    sched = MicroBatchScheduler(FakeBackend(), max_batch=2, max_wait_s=0.01)
    assert sched.submit("truoc khi rao").result(timeout=10).text is not None
    successor = sched._fence_replacement()
    errors: list = []

    def close():
        try:
            sched.close(timeout=10)
        except Exception as e:  # surfaced to the assertion below
            errors.append(e)

    closer = threading.Thread(target=close, daemon=True)
    closer.start()
    time.sleep(0.2)
    assert closer.is_alive()  # waiting for the start, not raising
    sched._start_replacement(successor)
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert errors == []
    assert not successor.is_alive()


# -- recovery: hung slot loop -> teardown + requeue + byte-identity ----------


def test_slot_loop_rebuild_byte_identity_for_requeued_requests():
    prompts = [
        f"<content>\nvan ban {i} mot hai ba bon nam sau bay tam\n</content>"
        for i in range(3)
    ]
    reference = FakeBackend(segment_words=2).generate(prompts)

    wd = Watchdog(interval_s=0.03, loop_deadline_s=5.0, dispatch_base_s=5.0,
                  segment_budget_s=0.25)
    wd.start()
    backend = FakeBackend(segment_words=2, segment_overhead_s=0.005)
    sched = InflightScheduler(backend, slots=4, max_wait_s=0.02, watchdog=wd)
    plan = FaultPlan([FaultSpec(site="fake.slot_step", kind="hang",
                                on_call=2, delay_s=0.0)])
    try:
        with injected(plan):
            futs = [sched.submit(p) for p in prompts]
            outs = [f.result(timeout=15).text for f in futs]
        # requeued residents complete byte-identically on the rebuilt loop
        assert outs == reference
        assert wd.stalls_total["dispatch"] == 1
        _wait_until(lambda: wd.recoveries_total == 1)
        stats = sched.metrics.snapshot()
        assert stats.requeues >= 3  # every resident went back via requeue
    finally:
        plan.release_hangs()
        sched.close(timeout=5)
        wd.close()


def test_fused_slot_loop_hang_recovery_byte_identity():
    """A hang inside a FUSED dispatch (N=2): the N-scaled budget keeps
    healthy fused dispatches unflagged, the wedged one trips exactly once,
    and the rebuilt loop (same fused_segments) replays every requeued
    resident byte-identically."""
    prompts = [
        f"<content>\nhop nhat {i} mot hai ba bon nam sau bay tam\n</content>"
        for i in range(3)
    ]
    reference = FakeBackend(segment_words=2).generate(prompts)

    wd = Watchdog(interval_s=0.03, loop_deadline_s=5.0, dispatch_base_s=5.0,
                  segment_budget_s=0.25)
    wd.start()
    backend = FakeBackend(segment_words=2, segment_overhead_s=0.005)
    sched = InflightScheduler(backend, slots=4, max_wait_s=0.02, watchdog=wd,
                              fused_segments=2)
    plan = FaultPlan([FaultSpec(site="fake.slot_step", kind="hang",
                                on_call=2, delay_s=0.0)])
    try:
        with injected(plan):
            futs = [sched.submit(p) for p in prompts]
            outs = [f.result(timeout=15).text for f in futs]
        assert outs == reference
        assert wd.stalls_total["dispatch"] == 1
        _wait_until(lambda: wd.recoveries_total == 1)
        stats = sched.metrics.snapshot()
        assert stats.requeues >= 3
        # the post-recovery traffic really ran fused
        assert stats.fused_dispatches > 0
    finally:
        plan.release_hangs()
        sched.close(timeout=5)
        wd.close()


def test_hung_slot_admit_requeues_pending_and_serves():
    wd = Watchdog(interval_s=0.03, loop_deadline_s=5.0, dispatch_base_s=0.25,
                  dispatch_per_token_s=0.0)
    wd.start()
    backend = FakeBackend(segment_words=4)
    sched = InflightScheduler(backend, slots=4, max_wait_s=0.02, watchdog=wd)
    plan = FaultPlan([FaultSpec(site="fake.slot_admit", kind="hang",
                                on_call=1, delay_s=0.0)])
    try:
        with injected(plan):
            futs = [
                sched.submit(
                    f"<content>\ncho doi {i} roi van xong\n</content>"
                )
                for i in range(2)
            ]
            outs = [f.result(timeout=15).text for f in futs]
        assert all("cho doi" in o for o in outs)
        _wait_until(lambda: wd.recoveries_total == 1)
    finally:
        plan.release_hangs()
        sched.close(timeout=5)
        wd.close()


# -- escalation: helper stalls escalate ---------------------------------------


def test_helper_stall_escalation_fires_on_escalate():
    clock = FakeClock()
    escalated = threading.Event()

    def escalate(stall):
        # what the HTTP server wires (minus os._exit)
        assert stall.kind == "helper"
        escalated.set()

    wd = Watchdog(loop_deadline_s=5.0, helper_deadline_s=10.0, clock=clock,
                  on_escalate=escalate)
    wd.register("stats-helper", kind="helper")
    clock.advance(11.0)
    for s in wd.tick():
        pass
    assert escalated.is_set()


# -- drain beats an in-flight sleep (the latent-gap fix) ---------------------


def test_drain_wins_over_injected_latency_sleep():
    """A latency fault far longer than the drain budget must not stall a
    graceful close: request_drain aborts the simulated sleep, the rider
    completes (outputs are sleep-independent), and close returns fast."""
    backend = FakeBackend()
    sched = MicroBatchScheduler(backend, max_batch=2, max_wait_s=0.01)
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="latency",
                                on_call=1, delay_s=30.0)])
    with injected(plan):
        fut = sched.submit("<content>\nngu lau qua thi thoi\n</content>")
        time.sleep(0.15)  # let the dispatch enter its 30s injected sleep
        t0 = time.monotonic()
        sched.close(drain=True, timeout=10.0)
        assert time.monotonic() - t0 < 5.0  # not the 30s sleep, not 10s
    assert "ngu lau" in fut.result(timeout=5).text


def test_drain_wins_over_latency_model_sleep():
    backend = FakeBackend(batch_overhead_s=30.0)
    sched = MicroBatchScheduler(backend, max_batch=2, max_wait_s=0.01)
    fut = sched.submit("<content>\nmo hinh tre cao van phai thoat\n</content>")
    time.sleep(0.15)
    t0 = time.monotonic()
    sched.close(drain=True, timeout=10.0)
    assert time.monotonic() - t0 < 5.0
    assert "mo hinh" in fut.result(timeout=5).text


# -- HTTP surfaces: /debug/stacks, /healthz watchdog line, /metrics ----------


@pytest.fixture()
def watchdog_server():
    from vnsum_tpu_torch.serve.server import ServeState, make_server

    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005,
                       trace_sample=0.0, watchdog_interval_s=0.1,
                       watchdog_exit_on_escalate=False)
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base, state
    finally:
        server.shutdown()
        server.server_close()
        state.close(drain_timeout_s=5)


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


def test_debug_stacks_and_healthz_watchdog_line(watchdog_server):
    base, state = watchdog_server
    status, body = _get(base + "/debug/stacks")
    assert status == 200
    names = {t["name"] for t in body["threads"]}
    assert "vnsum-serve-scheduler" in names
    assert "vnsum-serve-watchdog" in names
    sched_stack = next(t for t in body["threads"]
                       if t["name"] == "vnsum-serve-scheduler")
    assert any("take_batch" in ln for ln in sched_stack["stack"])
    assert body["watchdog"]["stalls_total"] == 0
    assert "scheduler" in body["watchdog"]["threads"]

    _, health = _get(base + "/healthz")
    assert "watchdog" in health
    assert health["watchdog"]["threads"]["scheduler"] < 30.0
    assert health["watchdog"]["stalls_total"] == 0

    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
    assert 'vnsum_serve_watchdog_stalls_total{kind="dispatch"} 0' in text
    assert "vnsum_serve_watchdog_recoveries_total 0" in text
    assert "vnsum_serve_watchdog_hung_dispatches_total 0" in text
    assert 'vnsum_serve_watchdog_heartbeat_age_seconds{thread="scheduler"}' \
        in text
