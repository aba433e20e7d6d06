"""Fault-tolerant serving acceptance: seeded fault injection driving the
supervisor's recovery paths — retry with backoff, batch bisection /
poison quarantine, the degradation ladder with recovery probes, radix-pin
and slot hygiene across crashes, typed drain-overrun sheds, and the
brownout 503 contract over the live HTTP front-end. Everything hermetic
(FakeBackend + vnsum_tpu_torch.testing.faults); the cardinal assertion repeated
throughout: EVERY future resolves — success, typed failure, or typed shed —
no hangs."""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import (
    EngineSupervisor,
    FailureClass,
    InflightScheduler,
    MicroBatchScheduler,
    RequestFailed,
    RequestShed,
    RetryPolicy,
    Rung,
    ShedReason,
)
from vnsum_tpu_torch.serve.supervisor import FatalEngineError, classify_failure
from vnsum_tpu_torch.testing.faults import (
    FaultPlan,
    FaultSpec,
    InjectedResourceExhausted,
    injected,
    parse_plan,
    plan_from_env,
)

FAST = RetryPolicy(max_attempts=3, backoff_base_s=0.005, backoff_max_s=0.05,
                   jitter=0.0)


def _supervised(backend=None, *, policy=FAST, max_batch=8, max_wait_s=0.2,
                cls=MicroBatchScheduler, **sup_kw):
    backend = backend or FakeBackend()
    sup = EngineSupervisor(policy, **sup_kw)
    sched = cls(backend, max_batch=max_batch, max_wait_s=max_wait_s,
                supervisor=sup)
    return backend, sup, sched


def _collect(futs, timeout=30):
    """Resolve every future: (value-or-exception per future). Raises on a
    HANG — the one outcome nothing in this suite may produce."""
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=timeout))
        except Exception as e:  # noqa: BLE001 - recorded for assertions
            out.append(e)
    return out


# -- fault plan mechanics ----------------------------------------------------


def test_fault_plan_is_deterministic_per_seed():
    def schedule(seed):
        plan = FaultPlan(
            [FaultSpec(site="s", kind="raise", probability=0.5)], seed=seed
        )
        hits = []
        for i in range(50):
            try:
                plan.fire("s")
                hits.append(False)
            except RuntimeError:
                hits.append(True)
        return hits

    a, b, c = schedule(7), schedule(7), schedule(8)
    assert a == b  # same seed -> identical firing schedule
    assert a != c  # different seed -> different schedule
    assert any(a) and not all(a)


def test_fault_plan_env_format_and_times_cap(monkeypatch):
    monkeypatch.setenv(
        "VNSUM_FAULTS",
        "seed=7;fake.dispatch:resource@every_n=2,times=1;"
        "fake.prefill:poison@match=DOC-13",
    )
    plan = plan_from_env()
    assert plan is not None and plan.seed == 7
    with pytest.raises(InjectedResourceExhausted):
        plan.fire("fake.dispatch")
        plan.fire("fake.dispatch")
    # times=1: the every_n rule is spent
    plan.fire("fake.dispatch")
    plan.fire("fake.dispatch")
    # poison needs its match present in the dispatch
    plan.fire("fake.prefill", prompts=["van ban lanh"])
    with pytest.raises(RuntimeError, match="poison"):
        plan.fire("fake.prefill", prompts=["tieu de DOC-13 xau"])
    assert [k for _s, k, _n in plan.fired] == ["resource", "poison"]


def test_parse_plan_rejects_malformed():
    with pytest.raises(ValueError):
        parse_plan("not-a-spec")
    with pytest.raises(ValueError):
        parse_plan("site:poison")  # poison without match
    with pytest.raises(ValueError):
        parse_plan("site:raise@bogus=1")
    # a selector-less non-poison spec would never fire — the plan must
    # refuse to arm vacuously instead of letting CI pass green untested
    with pytest.raises(ValueError, match="on_call"):
        parse_plan("site:raise")


def test_classifier():
    assert classify_failure(RuntimeError("boom")) is FailureClass.TRANSIENT
    assert classify_failure(MemoryError()) is FailureClass.RESOURCE
    assert (classify_failure(RuntimeError("RESOURCE_EXHAUSTED: oom"))
            is FailureClass.RESOURCE)
    assert classify_failure(ValueError("bad")) is FailureClass.POISON
    assert classify_failure(FatalEngineError("gone")) is FailureClass.FATAL
    e = RuntimeError("x")
    e.fatal = True
    assert classify_failure(e) is FailureClass.FATAL


# -- one-shot path: retry / bisect / quarantine ------------------------------


def test_transient_crash_retries_and_every_future_resolves():
    backend, sup, sched = _supervised()
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="raise", on_call=1)])
    try:
        with injected(plan):
            futs = [sched.submit(f"tai lieu {i} " * 10) for i in range(5)]
            outs = _collect(futs)
        assert all(c.record.status == "ok" for c in outs)
        # outputs identical to an unfaulted backend — the retry re-ran the
        # same prompts, it didn't corrupt them
        fresh = FakeBackend()
        for i, c in enumerate(outs):
            assert c.text == fresh.generate([f"tai lieu {i} " * 10])[0]
        s = sched.metrics.snapshot()
        assert s.failures.get("transient") == 1
        assert s.retries == 5 and s.completed == 5 and s.errors == 0
        assert s.backoff_seconds > 0
    finally:
        sched.close()


def test_poison_request_is_bisected_out_and_only_it_fails():
    backend, sup, sched = _supervised(
        policy=RetryPolicy(max_attempts=2, backoff_base_s=0.005, jitter=0.0)
    )
    plan = FaultPlan(
        [FaultSpec(site="fake.dispatch", kind="poison", match="DOC-POISON")]
    )
    try:
        prompts = [f"van ban sach {i} " * 8 for i in range(6)]
        prompts[3] = "van ban DOC-POISON doc hai " * 8
        with injected(plan):
            futs = [sched.submit(p) for p in prompts]
            res = _collect(futs)
        # ONLY the poison request failed, typed, with the POISON class
        for i, r in enumerate(res):
            if i == 3:
                assert isinstance(r, RequestFailed)
                assert r.failure_class is FailureClass.POISON
            else:
                assert r.record.status == "ok"
        s = sched.metrics.snapshot()
        assert s.bisects >= 1 and s.quarantined == 1
        assert s.completed == 5 and s.errors == 1
    finally:
        sched.close()


def test_immediate_poison_class_skips_retries():
    """A PERMANENT_ERRORS-class failure (ValueError) bisects straight away:
    no retry budget is burned re-running a deterministic input error."""
    class Picky(FakeBackend):
        def generate(self, prompts, **kw):
            if any("hong" in p for p in prompts):
                raise ValueError("malformed input row")
            return super().generate(prompts, **kw)

    backend, sup, sched = _supervised(Picky())
    try:
        prompts = ["lanh a " * 6, "bi hong " * 6, "lanh b " * 6]
        futs = [sched.submit(p) for p in prompts]
        res = _collect(futs)
        assert isinstance(res[1], RequestFailed)
        assert res[1].failure_class is FailureClass.POISON
        assert res[0].record.status == "ok" and res[2].record.status == "ok"
        s = sched.metrics.snapshot()
        assert s.retries == 0  # bisection only — no backoff retries
        assert s.failures.get("poison", 0) >= 1
    finally:
        sched.close()


def test_fatal_failure_fails_whole_group_without_retry():
    backend, sup, sched = _supervised()
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="fatal",
                                on_call=1)])
    try:
        with injected(plan):
            futs = [sched.submit(f"chet {i} " * 5) for i in range(3)]
            res = _collect(futs)
        assert all(isinstance(r, RequestFailed) for r in res)
        assert all(r.failure_class is FailureClass.FATAL for r in res)
        assert sched.metrics.snapshot().retries == 0
        # the scheduler thread survived: next submit still served
        ok = sched.submit("van song " * 5).result(timeout=30)
        assert ok.record.status == "ok"
    finally:
        sched.close()


def test_unsupervised_scheduler_keeps_raw_error_contract():
    """supervisor=None is the pre-supervision contract: the raw error on
    every rider, no retries — what the direct-API tests pin."""
    sched = MicroBatchScheduler(FakeBackend(), max_batch=4, max_wait_s=0.1)
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="raise",
                                every_n=1)])
    try:
        with injected(plan):
            futs = [sched.submit(f"tho {i} " * 5) for i in range(2)]
            res = _collect(futs)
        assert all(type(r).__name__ == "InjectedFault" for r in res)
    finally:
        sched.close()


def test_expired_deadline_during_backoff_is_shed_not_redispatched():
    backend, sup, sched = _supervised(
        policy=RetryPolicy(max_attempts=5, backoff_base_s=0.2,
                           backoff_max_s=0.2, jitter=0.0)
    )
    plan = FaultPlan([FaultSpec(site="fake.dispatch", kind="raise",
                                every_n=1, times=2)])
    try:
        with injected(plan):
            f = sched.submit("gap rut " * 5,
                             deadline=time.monotonic() + 0.1)
            with pytest.raises(RequestShed) as exc:
                f.result(timeout=30)
        assert exc.value.reason is ShedReason.DEADLINE
    finally:
        sched.close()


# -- degradation ladder ------------------------------------------------------


def test_resource_burst_steps_ladder_down_and_probe_recovers():
    backend, sup, sched = _supervised(
        policy=RetryPolicy(max_attempts=6, backoff_base_s=0.005, jitter=0.0),
        resource_strikes_per_step=2, probe_interval_s=0.15,
    )
    plan = FaultPlan([
        FaultSpec(site="fake.dispatch", kind="resource", on_call=1),
        FaultSpec(site="fake.dispatch", kind="resource", on_call=2),
    ])
    try:
        with injected(plan):
            futs = [sched.submit(f"qua tai {i} " * 6) for i in range(6)]
            outs = _collect(futs)
        assert all(c.record.status == "ok" for c in outs)
        assert sup.rung == Rung.REDUCED_BATCH
        # REDUCED_BATCH halves dispatch width: post-step-down batches are
        # no wider than max_batch // 2
        step_down_sizes = backend.batch_sizes[1:]
        assert step_down_sizes and max(step_down_sizes) <= 4
        s = sched.metrics.snapshot()
        assert s.degraded_steps == 1
        assert s.failures.get("resource_exhausted") == 2
        time.sleep(0.2)
        ok = sched.submit("hoi phuc " * 5).result(timeout=30)
        assert ok.record.status == "ok"
        assert sup.rung == Rung.HEALTHY
        assert sched.metrics.snapshot().degraded_recoveries == 1
    finally:
        sched.close()


def test_no_spec_rung_drops_references_no_cache_rung_stops_inserts():
    backend = FakeBackend(prefix_cache_blocks=64, cache_block_tokens=4,
                          spec_k=4)
    _, sup, sched = _supervised(backend)
    try:
        # healthy: references ride, inserts happen
        sched.submit("mot tieu de chung rat dai " * 4 + "duoi mot",
                     reference="mot tieu de chung").result(timeout=30)
        assert backend.references_seen[-1] == "mot tieu de chung"
        used0 = backend.prefix_index.stats_dict()["blocks_used"]
        assert used0 > 0
        # force NO_CACHE_INSERT (implies NO_SPEC)
        for _ in range(6):
            sup.note_failure(FailureClass.RESOURCE)
        assert sup.rung >= Rung.NO_CACHE_INSERT
        sched.submit("mot tieu de chung rat dai " * 4 + "duoi hai la khac",
                     reference="mot tieu de chung").result(timeout=30)
        # spec reference dropped by the dispatch gate
        assert backend.references_seen[-1] is None
        # no new blocks inserted, but the cached prefix still served
        d = backend.prefix_index.stats_dict()
        assert d["blocks_used"] == used0
        rec = sched.metrics.snapshot()
        assert rec.cache_hit_tokens > 0
    finally:
        sched.close()


def test_brownout_sheds_typed_with_retry_after_and_heals():
    backend, sup, sched = _supervised(
        resource_strikes_per_step=1, probe_interval_s=0.1,
        brownout_retry_after_s=2.5,
    )
    try:
        for _ in range(4):
            sup.note_failure(FailureClass.RESOURCE)
        assert sup.rung == Rung.BROWNOUT
        with pytest.raises(RequestShed) as exc:
            sched.submit("bi chan " * 4)
        assert exc.value.reason is ShedReason.BROWNOUT
        assert exc.value.retry_after_s == 2.5
        # internal fan-out of already-admitted work still runs
        c = sched.submit("noi bo " * 4, internal=True).result(timeout=30)
        assert c.record.status == "ok"
        # the admission knock itself probes recovery after the interval
        time.sleep(0.12)
        ok = sched.submit("mo lai " * 4).result(timeout=30)
        assert ok.record.status == "ok"
        assert sup.rung < Rung.BROWNOUT
    finally:
        sched.close()


# -- in-flight path ----------------------------------------------------------


def test_inflight_segment_crash_retries_all_resolve():
    backend = FakeBackend(segment_words=4)
    _, sup, sched = _supervised(backend, cls=InflightScheduler)
    plan = FaultPlan([FaultSpec(site="fake.slot_step", kind="raise",
                                on_call=2)])
    try:
        with injected(plan):
            futs = [sched.submit(f"tai lieu {i} van ban dai " * 6)
                    for i in range(4)]
            outs = _collect(futs)
        assert all(c.record.status == "ok" for c in outs)
        fresh = FakeBackend(segment_words=4)
        for i, c in enumerate(outs):
            assert c.text == fresh.generate(
                [f"tai lieu {i} van ban dai " * 6]
            )[0]
        s = sched.metrics.snapshot()
        assert s.retries >= 1 and s.failures.get("transient") == 1
        # slots freed: the crashed loop was dropped, nothing resident
        total, busy = sched.slot_state()
        assert busy == 0
    finally:
        sched.close()


def test_inflight_poison_resident_quarantined_others_survive():
    backend = FakeBackend(segment_words=4)
    _, sup, sched = _supervised(
        backend, cls=InflightScheduler,
        policy=RetryPolicy(max_attempts=2, backoff_base_s=0.005, jitter=0.0),
    )
    # the poison prompt crashes BOTH the slot loop's segments and the
    # one-shot retry path, so quarantine must come from bisection
    plan = FaultPlan([
        FaultSpec(site="fake.slot_step", kind="poison", match="DOC-POISON"),
        FaultSpec(site="fake.dispatch", kind="poison", match="DOC-POISON"),
    ])
    try:
        prompts = [f"van ban {i} rat dai nhieu chu " * 6 for i in range(4)]
        prompts[2] = "van ban DOC-POISON doc hai " * 6
        with injected(plan):
            futs = [sched.submit(p) for p in prompts]
            res = _collect(futs)
        assert isinstance(res[2], RequestFailed)
        assert res[2].failure_class is FailureClass.POISON
        for i in (0, 1, 3):
            assert res[i].record.status == "ok"
        assert sched.metrics.snapshot().quarantined == 1
    finally:
        sched.close()


def test_inflight_admit_crash_recovers():
    backend = FakeBackend(segment_words=4)
    _, sup, sched = _supervised(backend, cls=InflightScheduler)
    plan = FaultPlan([FaultSpec(site="fake.slot_admit", kind="raise",
                                on_call=1)])
    try:
        with injected(plan):
            futs = [sched.submit(f"nhap cuoc {i} " * 6) for i in range(3)]
            outs = _collect(futs)
        assert all(c.record.status == "ok" for c in outs)
    finally:
        sched.close()


# -- resource hygiene across crashes -----------------------------------------


def test_radix_pins_return_to_prebatch_level_after_crash():
    backend = FakeBackend(prefix_cache_blocks=64, cache_block_tokens=4)
    _, sup, sched = _supervised(backend)
    try:
        header = "tieu de dung chung rat dai on dinh " * 4
        sched.submit(header + "duoi mot").result(timeout=30)
        assert backend.prefix_index.pinned_blocks == 0
        # crash WHILE the cache pass holds pins (the fake.prefill site), on
        # every attempt: the request is eventually quarantined, and not one
        # pin may leak across all those crashed dispatches
        plan = FaultPlan([FaultSpec(site="fake.prefill", kind="raise",
                                    every_n=1)])
        with injected(plan):
            f = sched.submit(header + "duoi hai khac biet")
            res = _collect([f])
        assert isinstance(res[0], RequestFailed)
        assert backend.prefix_index.pinned_blocks == 0
        # and the cache still works afterwards
        c = sched.submit(header + "duoi ba").result(timeout=30)
        assert c.record.status == "ok"
        assert backend.prefix_index.pinned_blocks == 0
    finally:
        sched.close()


# -- drain overrun -----------------------------------------------------------


class _HungBackend(FakeBackend):
    """generate() blocks until released — a wedged engine dispatch."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.release = threading.Event()

    def generate(self, prompts, **kw):
        self.release.wait(timeout=10)
        return super().generate(prompts, **kw)


def test_drain_overrun_sheds_queued_and_inflight_futures_typed():
    backend = _HungBackend()
    sched = MicroBatchScheduler(backend, max_batch=1, max_wait_s=0.0)
    futs = [sched.submit(f"ket cung {i} " * 4) for i in range(3)]
    t0 = time.monotonic()
    sched.close(drain=True, timeout=0.3)
    assert time.monotonic() - t0 < 5.0
    for f in futs:  # every future resolves with the typed shed — no hangs
        with pytest.raises(RequestShed) as exc:
            f.result(timeout=5)
        assert exc.value.reason is ShedReason.SHUTDOWN
    shed = sched.metrics.snapshot().shed
    assert shed.get("shutdown", 0) == 3
    backend.release.set()


def test_inflight_drain_overrun_sheds_resident_slots():
    class HungSegments(FakeBackend):
        def __init__(self):
            super().__init__(segment_words=2)
            self.release = threading.Event()

        def start_slot_loop(self, *a, **kw):
            loop = super().start_slot_loop(*a, **kw)
            orig = loop.step

            def slow_step():
                self.release.wait(timeout=10)
                return orig()

            loop.step = slow_step
            return loop

    backend = HungSegments()
    sched = InflightScheduler(backend, slots=2, max_wait_s=0.05)
    futs = [sched.submit(f"ngu quen {i} nhieu tu lam " * 8)
            for i in range(2)]
    time.sleep(0.3)  # let the loop admit them before closing
    sched.close(drain=True, timeout=0.3)
    for f in futs:
        with pytest.raises(RequestShed) as exc:
            f.result(timeout=5)
        assert exc.value.reason is ShedReason.SHUTDOWN
    backend.release.set()


# -- HTTP contract -----------------------------------------------------------


@pytest.fixture()
def degraded_server():
    from vnsum_tpu_torch.serve.server import ServeState, make_server

    sup = EngineSupervisor(FAST, resource_strikes_per_step=1,
                           probe_interval_s=30.0, brownout_retry_after_s=3.0)
    state = ServeState(FakeBackend(), max_batch=4, max_wait_s=0.005,
                       supervisor=sup)
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state, sup
    server.shutdown()
    server.server_close()
    state.close()


def test_brownout_is_http_503_with_retry_after_and_healthz_reports_rung(
    degraded_server,
):
    base, state, sup = degraded_server
    # healthy first
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        d = json.loads(resp.read())
    assert d["status"] == "ok" and d["degraded_rung"] == 0
    for _ in range(4):
        sup.note_failure(FailureClass.RESOURCE)
    assert sup.rung == Rung.BROWNOUT
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        d = json.loads(resp.read())
    assert d["status"] == "degraded" and d["degraded_rung"] == 4
    assert d["degraded"] == "brownout"
    req = urllib.request.Request(
        base + "/v1/generate",
        data=json.dumps({"prompt": "xin chao " * 5}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 503
    assert exc.value.headers["Retry-After"] == "3"
    body = json.loads(exc.value.read())
    assert body["reason"] == "brownout" and body["retry_after_s"] == 3.0
    # the rung gauge is on /metrics
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    assert "vnsum_serve_degraded_rung 4" in text


# -- end-to-end seeded plan (the acceptance scenario) ------------------------


def test_seeded_fault_plan_end_to_end_metrics_and_outcomes():
    """Acceptance: crash on dispatch N + one poison request + a
    RESOURCE_EXHAUSTED burst, under one seeded plan. Zero unresolved
    futures, ONLY the poison request failed, the ladder stepped down and
    recovered, and /metrics shows all of it."""
    backend = FakeBackend()
    sup = EngineSupervisor(
        RetryPolicy(max_attempts=4, backoff_base_s=0.005,
                    backoff_max_s=0.02, jitter=0.25, seed=11),
        resource_strikes_per_step=2, probe_interval_s=0.15,
    )
    sched = MicroBatchScheduler(backend, max_batch=4, max_wait_s=0.05,
                                supervisor=sup)
    plan = FaultPlan([
        FaultSpec(site="fake.dispatch", kind="raise", on_call=2),
        FaultSpec(site="fake.dispatch", kind="resource", on_call=4),
        FaultSpec(site="fake.dispatch", kind="resource", on_call=5),
        FaultSpec(site="fake.dispatch", kind="poison", match="DOC-POISON"),
    ], seed=11)
    try:
        prompts = [f"tai lieu so {i} noi dung " * 8 for i in range(24)]
        prompts[13] = "tai lieu DOC-POISON hong " * 8
        with injected(plan):
            futs = []
            for p in prompts:
                futs.append(sched.submit(p))
                time.sleep(0.002)
            res = _collect(futs)
        # zero unresolved futures (collect would have timed out), and only
        # the poison request failed
        failed = [i for i, r in enumerate(res) if isinstance(r, Exception)]
        assert failed == [13]
        assert isinstance(res[13], RequestFailed)
        assert res[13].failure_class is FailureClass.POISON
        assert all(r.record.status == "ok"
                   for i, r in enumerate(res) if i != 13)
        s = sched.metrics.snapshot()
        assert s.completed == 23 and s.errors == 1
        assert s.degraded_steps >= 1  # the resource burst stepped down
        assert s.retries >= 1 and s.bisects >= 1 and s.quarantined == 1
        # recovery: quiet traffic after the burst climbs back to HEALTHY
        deadline = time.monotonic() + 5.0
        while sup.rung != Rung.HEALTHY and time.monotonic() < deadline:
            time.sleep(0.16)
            sched.submit("tham do hoi phuc " * 4).result(timeout=30)
        assert sup.rung == Rung.HEALTHY
        text = sched.metrics.render_prometheus(degraded_rung=int(sup.rung))
        assert 'vnsum_serve_fault_failures_total{class="resource_exhausted"} 2' in text
        assert "vnsum_serve_degraded_steps_total 1" in text
        assert "vnsum_serve_degraded_recoveries_total 1" in text
        assert "vnsum_serve_degraded_rung 0" in text
        assert "vnsum_serve_fault_quarantined_total 1" in text
    finally:
        sched.close()


def test_healthy_path_pays_no_extra_dispatches_under_supervision():
    """Supervision off the hot path: with no faults, a supervised scheduler
    performs EXACTLY the dispatches an unsupervised one does."""
    runs = []
    for supervised in (False, True):
        backend = FakeBackend()
        sup = EngineSupervisor(FAST) if supervised else None
        sched = MicroBatchScheduler(backend, max_batch=4, max_wait_s=0.2,
                                    supervisor=sup)
        try:
            barrier = threading.Barrier(8)
            futs = [None] * 8

            def worker(i):
                barrier.wait()
                futs[i] = sched.submit(f"deu nhau {i} " * 6)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            outs = _collect(futs)
            assert all(c.record.status == "ok" for c in outs)
            runs.append(sorted(backend.batch_sizes))
        finally:
            sched.close()
    assert runs[0] == runs[1]
    assert sum(runs[1]) == 8  # no request dispatched twice
