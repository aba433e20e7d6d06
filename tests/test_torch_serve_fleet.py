"""The replica fleet on the port (serve/router.py, serve/worker.py,
testing/chaos.py's RouterProcess): the cases of tests/test_serve_fleet.py
on the port's router over the port's FakeBackend workers, then the router
held to the JAX package's — the rendezvous pick over seeded worker sets,
``request_body_from_payload`` over journal payloads of every request kind,
the /healthz keys and /metrics families over the same traffic, each
package's router in front of the other's workers — a router over two
TorchBackend(device="cpu") workers on carried tiny weights answering the
JAX server's texts, the entry points (the router forwards ``--backend
torch`` by default, a torch worker with no card exits at startup, the
spawned argv names the port's worker module) and a RouterProcess whose
worker is SIGKILLed under load.

A "dead" worker is a socket bound and never listened on, held for the
test's life: its port refuses every connect, and no other process can
bind it in the meantime."""
from __future__ import annotations

import contextlib
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib

import pytest

from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.serve import journal as jax_journal
from vnsum_tpu.serve import router as jax_router
from vnsum_tpu.serve import server as jax_server
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve import journal as port_journal
from vnsum_tpu_torch.serve import router as port_router
from vnsum_tpu_torch.serve import server as port_server
from vnsum_tpu_torch.serve import worker as port_worker
from vnsum_tpu_torch.serve.journal import RequestJournal, aggregate_status
from vnsum_tpu_torch.serve.router import (
    RouterState,
    Worker,
    _RouterRequest,
    make_router_server,
    request_body_from_payload,
)
from vnsum_tpu_torch.serve.server import ServeState, make_server
from vnsum_tpu_torch.testing.chaos import (
    RouterProcess,
    free_port,
    http_delete,
    http_json,
)

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401


@contextlib.contextmanager
def dead_port():
    """A port that refuses connects for the block's life: bound, never
    listened on, and held, so nothing else can take it."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    try:
        yield sock.getsockname()[1]
    finally:
        sock.close()


def _spawn_inproc_worker(name: str, state_cls=ServeState, server_fn=make_server,
                         backend=None, worker_cls=Worker, **kw):
    """One in-process engine worker: full ServeState over FakeBackend on
    an ephemeral port — the /v1/* surface the router proxies to, without
    subprocess startup cost."""
    state = state_cls(backend if backend is not None else FakeBackend(),
                      max_batch=8, max_wait_s=0.005, **kw)
    server = server_fn(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    return worker_cls(name, "127.0.0.1", port), (server, state, thread)


def _close_worker(handles) -> None:
    server, state, _thread = handles
    server.shutdown()
    server.server_close()
    state.close()


def _mark_up(state) -> None:
    with state._lock:
        for w in state.workers:
            w.up = True


def _serve_router(state, server_fn=make_router_server):
    server = server_fn(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}", server


@pytest.fixture()
def fleet(tmp_path):
    """Two in-process workers behind a journaled router (probe loop ON,
    fast cadence). Yields (base_url, router_state, workers)."""
    w0, h0 = _spawn_inproc_worker("w0")
    w1, h1 = _spawn_inproc_worker("w1")
    state = RouterState(
        [w0, w1],
        journal_dir=tmp_path / "router",
        probe_interval_s=0.05,
        probe_timeout_s=2.0,
        down_after=2,
        up_after=1,
        tenants={"alpha": "interactive", "beta": "batch"},
    )
    state.start()
    base, server = _serve_router(state)
    state.wait_ready(timeout_s=10.0)
    yield base, state, [w0, w1]
    server.shutdown()
    server.server_close()
    state.close(drain_timeout_s=5.0)
    for h in (h0, h1):
        _close_worker(h)


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _post_any(url, payload, headers=None):
    """(status, body) for 200s and typed errors alike."""
    try:
        status, body, _ = _post(url, payload, headers)
        return status, body
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def _hint_for(workers, target_name: str) -> str:
    """A cache_hint whose rendezvous hash lands on ``target_name``."""
    for i in range(1000):
        hint = f"hint-{i}"
        best = max(workers, key=lambda w: zlib.crc32(
            f"{hint}|{w.name}".encode()
        ))
        if best.name == target_name:
            return hint
    raise AssertionError("no hint found")  # pragma: no cover


# -- the JAX file's cases -------------------------------------------------------


def test_router_proxies_generate_and_summarize(fleet):
    base, state, _workers = fleet
    status, body, _ = _post(base + "/v1/generate",
                            {"prompt": "xin chào fleet",
                             "max_new_tokens": 8, "request_id": "f-gen"})
    assert status == 200
    assert body["request_id"] == "f-gen"
    assert body["completions"][0]["text"]
    status, body, _ = _post(base + "/v1/summarize",
                            {"text": "nội dung tiếng Việt có dấu. " * 30,
                             "request_id": "f-sum"})
    assert status == 200
    assert body["summary"] and body["approach"]
    # both landed in the GLOBAL ledger as completed
    for rid in ("f-gen", "f-sum"):
        assert aggregate_status(state.journal.lookup(rid)) == "completed"


def test_least_loaded_spreads_across_workers(fleet):
    base, _state, workers = fleet
    for i in range(8):
        status, _, _ = _post(base + "/v1/generate",
                             {"prompt": f"tin số {i}",
                              "request_id": f"spread-{i}"})
        assert status == 200
    counts = [w.requests for w in workers]
    assert sum(counts) == 8
    # no-affinity traffic must not pile onto one worker
    assert all(c > 0 for c in counts)


def test_cache_affinity_is_sticky(fleet):
    base, _state, workers = fleet
    before = [w.requests for w in workers]
    for i in range(6):
        status, _, _ = _post(
            base + "/v1/generate",
            {"prompt": f"cùng tiền tố, đuôi {i}",
             "cache_hint": "shared-prefix-A", "request_id": f"aff-{i}"},
        )
        assert status == 200
    deltas = [w.requests - b for w, b in zip(workers, before)]
    # rendezvous hashing: one worker took all six, the other none
    assert sorted(deltas) == [0, 6]


def test_request_id_and_tenant_propagate_end_to_end(fleet):
    """ONE id crosses the router->worker hop — the client's X-Request-Id is
    the router's journal rid, the response echo, AND the worker-side trace
    id visible in that worker's /debug/trace ring."""
    base, state, workers = fleet
    rid = "trace-me-e2e"
    status, body, headers = _post(
        base + "/v1/generate",
        {"prompt": "định danh xuyên suốt"},
        headers={"X-Request-Id": rid, "X-Tenant": "alpha"},
    )
    assert status == 200
    assert body["request_id"] == rid
    assert headers["X-Request-Id"] == rid
    # the worker journaled/traced the SAME id (no router-side rewrite)
    assert body["completions"][0]["record"]["trace_id"] == rid
    found = False
    for w in workers:
        s, raw = _get(f"http://{w.host}:{w.port}/debug/trace")
        if s == 200 and rid in raw.decode():
            found = True
    assert found, "request id never appeared in any worker's trace ring"
    # the router ledger holds the same rid, completed
    assert aggregate_status(state.journal.lookup(rid)) == "completed"
    # tenant accounting happened at the front door
    s, raw = _get(base + "/healthz")
    assert json.loads(raw)["tenant_requests"].get("alpha", 0) >= 1


def test_unknown_tenant_is_typed_400(fleet):
    base, _state, _workers = fleet
    status, body = _post_any(base + "/v1/generate", {"prompt": "x"},
                             {"X-Tenant": "ghost"})
    assert status == 400
    assert "ghost" in body["error"] and "alpha" in body["tenants"]


def test_stream_is_typed_501(fleet):
    base, _state, _workers = fleet
    status, body = _post_any(base + "/v1/generate",
                             {"prompt": "x", "stream": True})
    assert status == 501
    assert body["error"] == "stream_unsupported"


def _failover_router(tmp_path, live, dead_name="dead", dead_port_=None, **kw):
    dead = Worker(dead_name, "127.0.0.1", dead_port_)
    state = RouterState([dead, live], journal_dir=tmp_path / "router", **kw)
    # no probe loop: both marked up by hand so the dead endpoint is
    # deterministically picked first via affinity
    _mark_up(state)
    with state._lock:
        state._replay_started = state._replay_done = True
    base, server = _serve_router(state)
    return dead, state, base, server


def test_inline_failover_replays_onto_survivor(tmp_path):
    """A worker that dies with the client still on the line: the proxy
    thread claims the journaled rids and re-dispatches onto the survivor —
    the client sees a 200, never the death."""
    live, handles = _spawn_inproc_worker("live")
    with dead_port() as port:
        dead, state, base, server = _failover_router(tmp_path, live,
                                                     dead_port_=port)
        try:
            hint = _hint_for([dead, live], "dead")
            status, body, _ = _post(
                base + "/v1/generate",
                {"prompt": "sống sót qua failover", "cache_hint": hint,
                 "request_id": "failover-1"},
            )
            assert status == 200
            text = body["completions"][0]["text"]
            assert aggregate_status(state.journal.lookup("failover-1")) \
                == "completed"
            assert dead.failovers >= 1 and live.requests >= 1
            # byte-identical to a direct hit on the survivor (deterministic
            # greedy engine + same payload)
            s2, direct, _ = _post(
                f"http://{live.host}:{live.port}/v1/generate",
                {"prompt": "sống sót qua failover", "cache_hint": hint},
            )
            assert s2 == 200 and direct["completions"][0]["text"] == text
        finally:
            server.shutdown()
            server.server_close()
            state.close(drain_timeout_s=2.0)
            _close_worker(handles)


def failover_trace_identity(tmp_path) -> None:
    """The journal-handoff replay after a worker death carries the
    ORIGINAL trace id onto the survivor — the client-facing request id,
    the X-Request-Id response header, and the survivor's own span ring
    all name the same trace, so the merged fleet trace can join the pre-
    and post-failover halves. (A function of its own so a steadiness run
    can repeat it in one process.)"""
    live, handles = _spawn_inproc_worker("live")
    with dead_port() as port:
        dead, state, base, server = _failover_router(tmp_path, live,
                                                     dead_port_=port)
        try:
            hint = _hint_for([dead, live], "dead")
            status, body, resp_headers = _post(
                base + "/v1/generate",
                {"prompt": "giữ nguyên dấu vết", "cache_hint": hint,
                 "request_id": "trace-keep-1"},
            )
            assert status == 200
            assert body["request_id"] == "trace-keep-1"
            assert resp_headers.get("X-Request-Id") == "trace-keep-1"
            # the survivor's span ring traced the replayed hop under the
            # ORIGINAL id; the worker's trace finishes in its handler's
            # finally — after the response bytes — so poll briefly
            _srv, live_state, _t = handles
            deadline = time.monotonic() + 5.0
            survivor_ids: set = set()
            while time.monotonic() < deadline:
                survivor_ids = {t.trace_id
                                for t in live_state.obs.snapshot()[0]}
                if "trace-keep-1" in survivor_ids:
                    break
                time.sleep(0.02)
            assert "trace-keep-1" in survivor_ids
            # and the router's own ring joined the same id, so the two
            # halves stitch into one merged trace. The router finishes its
            # trace in _proxy's finally, after the response bytes too, so
            # it is polled the same way
            deadline = time.monotonic() + 5.0
            router_ids: set = set()
            while time.monotonic() < deadline:
                router_ids = {t.trace_id for t in state.obs.snapshot()[0]}
                if "trace-keep-1" in router_ids:
                    break
                time.sleep(0.02)
            assert "trace-keep-1" in router_ids
            assert dead.failovers == 1
        finally:
            server.shutdown()
            server.server_close()
            state.close(drain_timeout_s=2.0)
            _close_worker(handles)


def test_failover_preserves_trace_identity_on_survivor(tmp_path):
    failover_trace_identity(tmp_path)


def test_death_handoff_leaves_attached_rids_to_the_inline_failover(tmp_path):
    """The probe loop's handoff from a dead or marked-down worker replays
    the rids no client waits on, and leaves those a proxy thread still owns
    to that thread's inline failover (the JAX router claims both, and a
    client whose claim it lost is answered a typed 503). Once the thread
    lets go of a rid it left unresolved, a handoff takes it."""
    live, handles = _spawn_inproc_worker("live")
    jlive, jhandles = _spawn_inproc_worker("live", jax_server.ServeState,
                                           jax_server.make_server, JaxFakeBackend(),
                                           jax_router.Worker)
    with dead_port() as port:
        states = []
        for sub, state_cls, worker_cls, lw in (
                ("port", RouterState, Worker, live),
                ("jax", jax_router.RouterState, jax_router.Worker, jlive)):
            dead = worker_cls("dead", "127.0.0.1", port)
            state = state_cls([dead, lw], journal_dir=tmp_path / sub)
            _mark_up(state)
            for rid in ("att-0", "loose-0"):
                state.journal.accept(_RouterRequest(trace_id=rid, prompt=f"tin {rid}",
                                                    max_new_tokens=8))
            state.assign(["att-0", "loose-0"], dead)
            states.append((state, dead))
        try:
            (state, dead), (jstate, jdead) = states
            with state._lock:
                state._attached.add("att-0")
            assert state._handoff(dead, "exit:-9") == 1
            assert aggregate_status(state.journal.lookup("loose-0")) == "completed"
            with state._lock:
                assert state._assigned.get("att-0") == "dead"
                assert "att-0" not in state._claimed
            assert aggregate_status(state.journal.lookup("att-0")) == "accepted"
            assert jstate._handoff(jdead, "exit:-9") == 2
            assert state._handoff(dead, "unreachable") == 0
            with state._lock:
                state._attached.discard("att-0")
            assert state._handoff(dead, "proxy_error") == 1
            assert aggregate_status(state.journal.lookup("att-0")) == "completed"
        finally:
            for state, _dead in states:
                state.close(drain_timeout_s=1.0)
            _close_worker(handles)
            _close_worker(jhandles)


def test_proxy_error_past_the_failover_hands_its_rids_off(fleet):
    """A worker round trip that raises something the inline failover does
    not catch (a truncated body is http.client.IncompleteRead, not an
    OSError) ends the client's connection; the rids it left assigned are
    handed off as it lets go of them, and complete on a worker."""
    import http.client

    base, state, workers = fleet
    real = state._worker_http
    raised = []

    def flaky(w, method, path, **kw):
        if method == "POST" and not raised:
            raised.append(w.name)
            raise http.client.IncompleteRead(b"")
        return real(w, method, path, **kw)

    state._worker_http = flaky
    with pytest.raises((urllib.error.URLError, http.client.HTTPException, OSError)):
        _post(base + "/v1/generate", {"prompt": "đứt giữa chừng", "request_id": "cut-1"})
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if aggregate_status(state.journal.lookup("cut-1")) == "completed":
            break
        time.sleep(0.02)
    assert raised and aggregate_status(state.journal.lookup("cut-1")) == "completed"
    with state._lock:
        assert not state._attached and "cut-1" not in state._assigned


def test_startup_replay_hands_unfinished_accepts_to_workers(tmp_path):
    """Router-restart recovery: unfinished ACCEPTs in the router's own
    journal re-dispatch once a worker is routable, and the replayed
    completion is byte-identical to a direct engine answer."""
    jdir = tmp_path / "router"
    journal = RequestJournal(jdir, fsync_interval_s=0.0)
    req = _RouterRequest(trace_id="replay-me",
                         prompt="bản tin chưa hoàn thành",
                         max_new_tokens=12)
    rid = journal.accept(req)
    journal.start(rid)
    journal.close()
    assert rid == "replay-me"

    live, handles = _spawn_inproc_worker("live")
    state = RouterState([live], journal_dir=jdir, probe_interval_s=0.05)
    state.start()
    try:
        state.wait_ready(timeout_s=10.0)
        t_end = time.monotonic() + 10.0
        while time.monotonic() < t_end:
            if aggregate_status(state.journal.lookup(rid)) == "completed":
                break
            time.sleep(0.02)
        entries = {e.rid: e for e in state.journal.lookup(rid)}
        assert entries[rid].terminal and entries[rid].status == "complete"
        s, direct, _ = _post(
            f"http://{live.host}:{live.port}/v1/generate",
            {"prompt": "bản tin chưa hoàn thành", "max_new_tokens": 12},
        )
        assert s == 200
        assert entries[rid].to_dict()["text"] \
            == direct["completions"][0]["text"]
    finally:
        state.close(drain_timeout_s=2.0)
        _close_worker(handles)


def test_router_readyz_typed_states(tmp_path):
    """/readyz on the router: pre_replay before the journal replays,
    no_worker with nothing routable, ready, then draining — each a typed
    reason a load balancer can branch on."""
    live, handles = _spawn_inproc_worker("live")
    state = RouterState([live], journal_dir=tmp_path / "router",
                        probe_interval_s=0.05)
    try:
        assert state.readiness() == (False, "pre_replay")
        with state._lock:
            state._replay_started = state._replay_done = True
        assert state.readiness() == (False, "no_worker")
        _mark_up(state)
        assert state.readiness() == (True, "ready")
        with state._lock:
            state._draining = True
        assert state.readiness() == (False, "draining")
        with state._lock:
            state._draining = False
    finally:
        state.close(drain_timeout_s=1.0)
        _close_worker(handles)


def test_front_door_saturation_is_typed_429(fleet):
    base, state, _workers = fleet
    state.max_inflight = 0  # saturate the front door
    try:
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"prompt": "x"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 429
        body = json.loads(exc.value.read())
        assert body["reason"] == "queue_full"
        assert exc.value.headers["Retry-After"]
    finally:
        state.max_inflight = 256


def test_router_metrics_surface(fleet):
    """The router /metrics renders only registered names and carries
    per-worker + journal series."""
    base, _state, _workers = fleet
    _post(base + "/v1/generate", {"prompt": "đo lường"})
    status, raw = _get(base + "/metrics")
    assert status == 200
    text = raw.decode()
    from vnsum_tpu_torch.serve.metrics import metric_names

    registered = set(metric_names())
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name = line.split("{")[0].split(" ")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            # histogram sample names derive from a registered base
            if name not in registered and name.endswith(suffix):
                name = name[: -len(suffix)]
        assert name in registered, line
    assert 'vnsum_serve_router_requests_total{worker="w0"}' in text
    assert 'vnsum_serve_router_sheds_total{reason="queue_full"}' in text
    assert "vnsum_serve_journal_pending" in text
    assert "vnsum_serve_router_workers_up 2" in text
    # fleet federation re-exports ride the same surface
    assert "vnsum_serve_federation_scrapes_total" in text
    assert 'vnsum_serve_fleet_incidents_total{reason="failover"} 0' in text


def test_cancel_routes_to_ledger(fleet):
    """DELETE on a completed rid answers from the global ledger (terminal
    entries stay terminal — cancel is idempotent, not destructive)."""
    base, state, _workers = fleet
    _post(base + "/v1/generate", {"prompt": "hủy tôi đi",
                                  "request_id": "cancel-me"})
    port = int(base.rsplit(":", 1)[1])
    status, body = http_json("GET", "127.0.0.1", port,
                             "/v1/requests/cancel-me")
    assert status == 200 and body["status"] == "completed"
    status, body = http_delete("127.0.0.1", port,
                               "/v1/requests/cancel-me")
    assert status == 200
    assert aggregate_status(state.journal.lookup("cancel-me")) \
        == "completed"


def test_rolling_restart_endpoint_answers_202(fleet):
    """Unspawned (externally managed) workers: the rolling restart
    accepts, then skips every worker it does not own."""
    base, state, _workers = fleet
    status, body, _ = _post(base + "/admin/rolling-restart", {})
    assert status == 202 and body["status"] == "rolling"
    t_end = time.monotonic() + 5.0
    while time.monotonic() < t_end:
        with state._lock:
            rolling = state._rolling
        if not rolling:
            break
        time.sleep(0.02)
    result = state.rolling_restart()
    assert result["status"] == "done"
    assert result["skipped"] == ["w0", "w1"] and not result["restarted"]


def test_request_body_from_payload_round_trip():
    """The handoff inverse: journal payload -> re-POST body keeps the
    fields the /v1/* surface accepts and nothing it rejects (summarize
    must not regrow sampling knobs — unknown fields are a typed 400)."""
    payload = {
        "prompt": "văn bản", "max_new_tokens": 32,
        "config": {"temperature": 0.7, "top_k": 40, "top_p": None,
                   "seed": 7, "spec_k": 2, "eos_ids": [0]},
        "reference": None, "cache_hint": "h1", "trace_id": "t",
        "deadline_unix": time.time() + 30.0, "tenant": "alpha",
    }
    path, body, headers = request_body_from_payload("rid-1", payload)
    assert path == "/v1/generate"
    assert body["prompt"] == "văn bản" and body["cache_hint"] == "h1"
    assert body["temperature"] == 0.7 and body["seed"] == 7
    assert "top_p" not in body and "eos_ids" not in body
    assert 0 < body["deadline_ms"] <= 30_000
    assert headers == {"X-Request-Id": "rid-1", "X-Tenant": "alpha"}

    spayload = {"prompt": "tóm tắt dài", "approach": "refine",
                "max_new_tokens": 64, "trace_id": "t2",
                "deadline_unix": None}
    path, body, headers = request_body_from_payload("rid-2", spayload)
    assert path == "/v1/summarize"
    assert body == {"request_id": "rid-2", "max_new_tokens": 64,
                    "text": "tóm tắt dài", "approach": "refine"}


# -- parity with the JAX router ---------------------------------------------------


def _twin_states(names):
    """(port RouterState, JAX RouterState) over equal worker rosters."""
    out = []
    for state_cls, worker_cls in ((RouterState, Worker),
                                  (jax_router.RouterState, jax_router.Worker)):
        workers = [worker_cls(n, "127.0.0.1", 20000 + i)
                   for i, n in enumerate(names)]
        out.append(state_cls(workers, federate=False))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_pick_ranks_as_jax(seed):
    """Seeded keys over seeded worker sets with mark-downs, drains,
    in-flight counts and exclusions: the port picks the JAX router's
    worker every time, and with a key it is the worker the crc32 of
    ``key|name`` ranks first among the routable ones."""
    rng = random.Random(seed)
    n = rng.randint(1, 7)
    names = rng.sample([f"worker-{i}" for i in range(12)]
                       + [f"w{i}" for i in range(12)], n)
    port_state, jax_state = _twin_states(names)
    picked_some = False
    for _ in range(300):
        rows = [(rng.random() < 0.75, rng.random() < 0.1, rng.randrange(4),
                 rng.randrange(20)) for _ in names]
        for state in (port_state, jax_state):
            for w, (up, draining, inflight, requests) in zip(state.workers, rows):
                w.up, w.draining = up, draining
                w.inflight, w.requests = inflight, requests
        affinity = rng.choice([None, "", f"hint-{rng.randrange(10**6)}",
                               f"tenant-{rng.randrange(50)}",
                               f"tài liệu {rng.randrange(10**4)}"])
        exclude = (set(rng.sample(names, rng.randint(0, n)))
                   if rng.random() < 0.5 else None)
        with port_state._lock, jax_state._lock:
            got = port_state._pick_locked(affinity, exclude)
            want = jax_state._pick_locked(affinity, exclude)
        assert (got.name if got else None) == (want.name if want else None)
        if got is not None and affinity:
            routable = [nm for nm, r in zip(names, rows) if r[0] and not r[1]]
            spared = [nm for nm in routable if not exclude or nm not in exclude]
            pool = spared or routable
            assert got.name == max(
                pool, key=lambda nm: zlib.crc32(f"{affinity}|{nm}".encode()))
            picked_some = True
    assert picked_some or n == 0


_BODIES = {
    "generate": ("/v1/generate", {"prompt": "văn bản cần tóm tắt", "max_new_tokens": 24},
                 None),
    "sampled": ("/v1/generate", {"prompt": "lấy mẫu", "temperature": 0.7, "top_k": 40,
                                 "top_p": 0.9, "seed": 7, "spec_k": 2}, None),
    "reference": ("/v1/generate", {"prompt": "có bản nháp", "reference": "bản nháp",
                                   "cache_hint": "h-ref"}, None),
    "fan-out": ("/v1/generate", {"prompts": ["một", "hai", "ba"],
                                 "cache_hints": ["a", None, "c"],
                                 "references": [None, "hai hai", None]}, None),
    "summarize": ("/v1/summarize", {"text": "nội dung dài. " * 20,
                                    "approach": "mapreduce_hierarchical",
                                    "max_new_tokens": 48}, None),
    "summarize-default": ("/v1/summarize", {"text": "ngắn gọn"}, None),
    "tenanted": ("/v1/generate", {"prompt": "khách hàng"}, ("bulk", "batch")),
    "tenanted-summarize": ("/v1/summarize", {"text": "tóm tắt", "approach": "skeleton"},
                           ("ui", "interactive")),
    "deadline": ("/v1/generate", {"prompt": "hạn chót", "deadline_ms": 30000}, None),
    "summarize-deadline": ("/v1/summarize", {"text": "hạn", "deadline_ms": 5000},
                           ("bulk", "batch")),
}


def _router_requests(pkg_router, pkg_server, path, req, qos):
    """The _RouterRequests the router's _journal_accepts builds for one
    body (its field reads, outside the handler)."""
    tenant, tier = qos or ("", "interactive")
    max_new = pkg_server._number(req, "max_new_tokens", int, integer=True)
    config = pkg_server._gen_config_from(req)
    deadline = pkg_server._deadline_from(req, None)
    if path == "/v1/summarize":
        return [pkg_router._RouterRequest(
            trace_id="rid", prompt=req.get("text", ""), max_new_tokens=max_new,
            deadline=deadline, tenant=tenant, tier=tier,
            approach=req.get("approach", "mapreduce"))]
    prompts = req.get("prompts") or [req.get("prompt", "")]
    refs = req.get("references") or [req.get("reference")] * len(prompts)
    hints = req.get("cache_hints") or [req.get("cache_hint")] * len(prompts)
    return [pkg_router._RouterRequest(
        trace_id="rid", prompt=p, max_new_tokens=max_new, config=config,
        reference=refs[i], cache_hint=hints[i], deadline=deadline, tenant=tenant,
        tier=tier) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("kind", list(_BODIES))
def test_request_body_from_payload_equal_jax(kind, monkeypatch):
    """Every request kind's journal payloads (each package's own
    request_payload over its router's request record) are equal, and
    ``request_body_from_payload`` rebuilds the same (path, body, headers)
    from them in both packages — the QoS class and the strategy name
    included."""
    path, req, qos = _BODIES[kind]
    payloads = []
    for pkg_router, pkg_server, pkg_journal in (
            (port_router, port_server, port_journal),
            (jax_router, jax_server, jax_journal)):
        rows = _router_requests(pkg_router, pkg_server, path, req, qos)
        payloads.append([pkg_journal.request_payload(r) for r in rows])
    for pp, pj in zip(*payloads):
        if pp["deadline_unix"] is not None:
            assert pp["deadline_unix"] == pytest.approx(pj["deadline_unix"], abs=1.0)
            pj["deadline_unix"] = pp["deadline_unix"]
        assert pp == pj
    monkeypatch.setattr(time, "time", lambda: 1_000_000.0)
    for i, payload in enumerate(payloads[0]):
        if payload["deadline_unix"] is not None:
            payload["deadline_unix"] = 1_000_000.0 + 12.3456
        rid = "rid" if i == 0 else f"rid#{i}"
        got = request_body_from_payload(rid, payload)
        assert got == jax_router.request_body_from_payload(rid, dict(payload))
        assert got[0] == path
        if qos:
            assert got[2]["X-Tenant"] == qos[0]
        if path == "/v1/summarize":
            assert got[1]["approach"] == req.get("approach", "mapreduce")
        if payload["deadline_unix"] is not None:
            assert got[1]["deadline_ms"] == 12345


def _router_pair(tmp_path, port_workers, jax_workers, **kw):
    """One router of each package over the given workers, marked up."""
    out = []
    for state_cls, server_fn, workers, sub in (
            (RouterState, make_router_server, port_workers, "port"),
            (jax_router.RouterState, jax_router.make_router_server, jax_workers, "jax")):
        state = state_cls(workers, journal_dir=tmp_path / sub / "router",
                          incident_dir=tmp_path / sub / "incidents",
                          incident_min_interval_s=0.0, **kw)
        _mark_up(state)
        with state._lock:
            state._replay_started = state._replay_done = True
        base, server = _serve_router(state, server_fn)
        out.append((base, state, server))
    return out


def _close_routers(routers) -> None:
    for _base, state, server in routers:
        server.shutdown()
        server.server_close()
        state.close(drain_timeout_s=2.0)


_TRAFFIC = [
    ("/v1/generate", {"prompt": "xin chào", "request_id": "p-1"}, None),
    ("/v1/generate", {"prompts": ["một", "hai"], "request_id": "p-2"}, "ui"),
    ("/v1/summarize", {"text": "văn bản dài. " * 30, "request_id": "p-3"}, "bulk"),
    ("/v1/generate", {"prompt": "x", "stream": True}, None),
    ("/v1/generate", {"prompt": "x"}, "ghost"),
    ("/v1/generate", {"prompt": "x", "temperatre": 1}, None),
    ("/v1/generate", {"prompt": "hết hạn", "deadline_ms": 0, "request_id": "p-7"}, None),
]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("watchdog", "tenant_requests", "sheds",
                                             "incidents"):
            out |= _keys(v, prefix + k + ".")
    return out


def _families(text: str) -> dict:
    """{metric name: TYPE} of a Prometheus text body."""
    return {parts[2]: parts[3] for parts in (line.split() for line in text.splitlines())
            if len(parts) == 4 and parts[:2] == ["#", "TYPE"]}


def test_healthz_and_metrics_equal_jax_router(tmp_path):
    """The same traffic through a router of each package, each over two
    FakeBackend workers of its own package: equal statuses and texts,
    equal /healthz keys (worker rows and their summary blocks too) and
    equal /metrics families and kinds; the mesh families are the only
    ones the JAX registry has and the port's does not."""
    tenants = {"ui": "interactive", "bulk": "batch"}
    pw = [_spawn_inproc_worker(f"worker-{i}") for i in range(2)]
    jw = [_spawn_inproc_worker(f"worker-{i}", jax_server.ServeState,
                               jax_server.make_server, JaxFakeBackend(),
                               jax_router.Worker) for i in range(2)]
    routers = _router_pair(tmp_path, [w for w, _ in pw], [w for w, _ in jw],
                           tenants=tenants)
    try:
        answers = []
        for base, _state, _server in routers:
            got = []
            for path, body, tenant in _TRAFFIC:
                status, resp = _post_any(base + path, body,
                                         {"X-Tenant": tenant} if tenant else None)
                got.append((status, resp.get("error"), resp.get("reason"),
                            [c["text"] for c in resp.get("completions", [])],
                            resp.get("summary")))
            answers.append(got)
        assert answers[0] == answers[1]
        assert [a[0] for a in answers[0]] == [200, 200, 200, 501, 400, 400, 429]
        for _base, state, _server in routers:
            state.federation.scrape_all()
        (_, hp), (_, hj) = [_get(base + "/healthz") for base, _s, _v in routers]
        hp, hj = json.loads(hp), json.loads(hj)
        assert _keys(hp) == _keys(hj)
        assert [_keys(r) for r in hp["workers"]] == [_keys(r) for r in hj["workers"]]
        assert hp["tenant_requests"] == hj["tenant_requests"]
        assert hp["sheds"] == hj["sheds"]
        (_, mp), (_, mj) = [_get(base + "/metrics") for base, _s, _v in routers]
        fp, fj = _families(mp.decode()), _families(mj.decode())
        assert fp == fj
        assert any(n.startswith("vnsum_serve_fleet_") for n in fp)
        assert any(n.startswith("vnsum_serve_federation_") for n in fp)
        # the router journals hold the same request ids and statuses
        for rid in ("p-1", "p-2", "p-3", "p-7"):
            statuses = [aggregate_status(state.journal.lookup(rid))
                        for _b, state, _s in routers]
            assert statuses[0] == statuses[1]
    finally:
        _close_routers(routers)
        for _w, h in pw + jw:
            _close_worker(h)


@pytest.mark.parametrize("combo", ["port-router+jax-workers", "jax-router+port-workers"])
def test_routers_and_workers_interoperate(combo, tmp_path):
    """Each package's router in front of the other package's FakeBackend
    workers answers as it does in front of its own: the protocol, not the
    package, is the contract."""
    port_front = combo.startswith("port")
    if port_front:
        mixed = [_spawn_inproc_worker(f"worker-{i}", jax_server.ServeState,
                                      jax_server.make_server, JaxFakeBackend())
                 for i in range(2)]
        own = [_spawn_inproc_worker(f"worker-{i}") for i in range(2)]
        state_cls, server_fn, worker_cls = RouterState, make_router_server, Worker
    else:
        mixed = [_spawn_inproc_worker(f"worker-{i}", worker_cls=jax_router.Worker)
                 for i in range(2)]
        own = [_spawn_inproc_worker(f"worker-{i}", jax_server.ServeState,
                                    jax_server.make_server, JaxFakeBackend())
               for i in range(2)]
        state_cls, server_fn = jax_router.RouterState, jax_router.make_router_server
        worker_cls = jax_router.Worker
    routers = []
    try:
        for sub, spawned in (("mixed", mixed), ("own", own)):
            workers = [worker_cls(w.name, w.host, w.port) for w, _h in spawned]
            state = state_cls(workers, journal_dir=tmp_path / sub)
            _mark_up(state)
            with state._lock:
                state._replay_started = state._replay_done = True
            base, server = _serve_router(state, server_fn)
            routers.append((base, state, server))
        answers = []
        for base, state, _server in routers:
            got = []
            for i in range(4):
                status, resp = _post_any(base + "/v1/generate",
                                         {"prompt": f"tin số {i}", "request_id": f"x-{i}",
                                          "cache_hint": f"hint-{i}"})
                got.append((status, resp["completions"][0]["text"]))
            status, resp = _post_any(base + "/v1/summarize",
                                     {"text": "văn bản dài. " * 30, "request_id": "x-s"})
            got.append((status, resp["summary"]))
            got.append(_post_any(base + "/v1/generate", {"prompt": "x", "bogus": 1})[0])
            state.federation.scrape_all()
            rollup = state.federation.fleet_rollup()
            got.append(rollup["counters"].get("requests_total"))
            got.append(sorted(state.federation.stats_dict().items())[-1])
            answers.append(got)
            assert aggregate_status(state.journal.lookup("x-s")) == "completed"
        assert answers[0] == answers[1]
        assert answers[0][-3] == 400
    finally:
        _close_routers(routers)
        for _w, h in mixed + own:
            _close_worker(h)


# -- torch workers on the CPU ---------------------------------------------------


TORCH_PROMPTS = [
    "văn bản một về kinh tế",
    "hai",
    "văn bản thứ ba dài hơn một chút về xã hội",
    "bốn bốn",
    "năm năm năm",
    "sáu và bảy",
]
TORCH_NEW = 24


@pytest.fixture(scope="module")
def torch_fleet():
    """The port's router over two in-process ServeState(TorchBackend(
    device="cpu")) workers on carried tiny f32 weights, and the JAX
    server over TpuBackend(interpret=True) on the same weights (caches
    within one 128-slot block, as tests/test_torch_serve_engine.py)."""
    import tempfile

    from vnsum_tpu.backend.engine import TpuBackend
    from vnsum_tpu_torch.backend.engine import TorchBackend

    jcfg, params, model = carried_weights(max_seq_len=128)
    common = dict(batch_size=8, max_new_tokens=TORCH_NEW, seed=1)
    watchdog = dict(watchdog_dispatch_base_s=600.0, watchdog_stall_s=600.0)
    spawned = [_spawn_inproc_worker(
        f"worker-{i}", backend=TorchBackend(model=model, flash=True, device="cpu",
                                            segment_tokens=4, **common), **watchdog)
        for i in range(2)]
    jstate = jax_server.ServeState(
        TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True, **common),
        max_batch=8, max_wait_s=0.02, **watchdog)
    jserver = jax_server.make_server(jstate, "127.0.0.1", 0)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    tmp = tempfile.TemporaryDirectory()
    state = RouterState([w for w, _h in spawned], journal_dir=f"{tmp.name}/router")
    _mark_up(state)
    with state._lock:
        state._replay_started = state._replay_done = True
    base, server = _serve_router(state)
    jbase = f"http://127.0.0.1:{jserver.server_address[1]}"
    status, body, _ = _post(jbase + "/v1/generate", {"prompts": TORCH_PROMPTS})
    assert status == 200
    yield base, state, [w for w, _h in spawned], [c["text"] for c in body["completions"]]
    _close_routers([(base, state, server)])
    for _w, h in spawned:
        _close_worker(h)
    jserver.shutdown()
    jserver.server_close()
    jstate.close(drain_timeout_s=60)
    tmp.cleanup()


def test_torch_workers_batch_matches_jax_server(torch_fleet):
    """One request of every prompt through the router lands on one torch
    worker as one engine batch: its texts are the JAX server's."""
    base, state, _workers, jax_texts = torch_fleet
    status, body, _ = _post(base + "/v1/generate",
                            {"prompts": TORCH_PROMPTS, "request_id": "tb-1"})
    assert status == 200
    assert [c["text"] for c in body["completions"]] == jax_texts
    assert any(jax_texts)  # the carried weights emit text
    assert aggregate_status(state.journal.lookup("tb-1")) == "completed"


def test_torch_workers_hinted_singles_match_jax_server(torch_fleet):
    """Each prompt alone, pinned by cache_hint to the worker the
    rendezvous ranking names: every worker serves, and each text is the
    JAX server's for that prompt."""
    base, _state, workers, jax_texts = torch_fleet
    before = [w.requests for w in workers]
    texts = []
    for i, prompt in enumerate(TORCH_PROMPTS):
        hint = _hint_for(workers, workers[i % 2].name)
        status, body, _ = _post(base + "/v1/generate",
                                {"prompt": prompt, "cache_hint": hint})
        assert status == 200
        texts.append(body["completions"][0]["text"])
    assert texts == jax_texts
    assert [w.requests - b for w, b in zip(workers, before)] == [3, 3]


# -- entry points ----------------------------------------------------------------


def test_worker_argv_names_the_port_worker(tmp_path):
    """The spawned command is the port's worker module: a string no import
    check sees, and the one line that keeps a port router off JAX
    workers."""
    handles = port_worker.build_fleet(2, str(tmp_path), extra_args=["--backend", "fake"])
    for i, h in enumerate(handles):
        argv = h.argv()
        assert argv[1:3] == ["-m", "vnsum_tpu_torch.serve.worker"]
        assert "vnsum_tpu.serve.worker" not in argv
        assert h.name == f"worker-{i}"
        assert h.journal_dir == str(tmp_path / h.name)
        assert argv[-2:] == ["--backend", "fake"]
    assert handles[0].port != handles[1].port


def test_router_forwards_backend_torch_by_default(tmp_path, monkeypatch):
    """``python -m vnsum_tpu_torch.serve.router`` without --backend gives
    its workers ``--backend torch`` (the port's engine on the card), and
    the named backend otherwise; --tenants rides along."""
    seen = []

    class Stop(Exception):
        pass

    def fake_build_fleet(n, fleet_dir, *, extra_args=None, env=None, host="127.0.0.1"):
        seen.append(list(extra_args))
        raise Stop

    monkeypatch.setattr(port_worker, "build_fleet", fake_build_fleet)
    for argv in ([], ["--backend", "fake"], ["--tenants", "ui:1:0"]):
        with pytest.raises(Stop):
            port_router.main(["--spawn-workers", "2", "--fleet-dir", str(tmp_path),
                              "--worker-args", "--max-batch 4", *argv])
    assert seen == [["--backend", "torch", "--max-batch", "4"],
                    ["--backend", "fake", "--max-batch", "4"],
                    ["--backend", "torch", "--max-batch", "4", "--tenants", "ui:1:0"]]
    with pytest.raises(SystemExit):
        port_router.main(["--spawn-workers", "2"])  # --fleet-dir is required


def test_worker_main_hands_flags_to_the_port_server(monkeypatch):
    got = []
    monkeypatch.setattr(port_server, "main", lambda argv: got.append(argv) or 7)
    assert port_worker.main(["--name", "worker-3", "--backend", "fake", "--port", "1"]) == 7
    assert got == [["--backend", "fake", "--port", "1"]]


def test_torch_worker_without_a_card_exits_at_startup(tmp_path):
    """A --backend torch worker on the default --device cuda, with no card
    visible, exits at startup: the handle's readiness wait reports the
    exit instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the worker would start")
    (h,) = port_worker.build_fleet(1, str(tmp_path),
                                   extra_args=["--backend", "torch", "--model", "tiny"])
    h.start()
    try:
        with pytest.raises(RuntimeError, match=r"exited during startup \(rc=1\)"):
            h.wait_ready(timeout_s=120.0)
        assert h.last_rc == 1 and not h.sealed_exit
    finally:
        h.sigkill()


def test_router_process_loses_nothing_when_a_worker_is_killed(tmp_path):
    """RouterProcess over two spawned --backend fake workers: requests
    pinned to worker-0 are in flight (a 1.5 s batch overhead) when its pid,
    read off the router's /healthz, is SIGKILLed. Every client still gets
    its 200 and text, the router journal completes every rid, the router
    counts the failover, respawns worker-0 and takes it back into
    rotation."""
    port = free_port()
    rp = RouterProcess(port, fleet_dir=str(tmp_path / "fleet"), spawn_workers=2,
                       extra_args=["--worker-args", "--fake-batch-overhead-ms 1500",
                                   "--probe-interval-ms", "100"])
    rp.start()
    try:
        rp.wait_ready(timeout_s=120.0)
        # both workers up before the load starts
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            _, health = http_json("GET", "127.0.0.1", port, "/healthz")
            if health["workers_up"] == 2:
                break
            time.sleep(0.1)
        pids = rp.worker_pids()
        workers = [Worker(n, "127.0.0.1", 0) for n in sorted(pids)]
        hint = _hint_for(workers, "worker-0")
        prompts = [f"bản tin số {i} cần giữ lại" for i in range(4)]
        replies: dict = {}

        def client(i):
            replies[i] = http_json("POST", "127.0.0.1", port, "/v1/generate",
                                   {"prompt": prompts[i], "cache_hint": hint,
                                    "request_id": f"kill-{i}"}, timeout=120.0)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        # the ACCEPTs reach worker-0's journal while its batch is held
        wdir = tmp_path / "fleet" / "worker-0"
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            entries, _, _ = RequestJournal.read_state(wdir) if wdir.exists() else ({}, 0, 0)
            if len(entries) == len(prompts):
                break
            time.sleep(0.02)
        assert len(entries) == len(prompts)
        killed = rp.kill_worker("worker-0")
        for t in threads:
            t.join(timeout=120.0)
        assert [replies[i][0] for i in range(len(prompts))] == [200] * len(prompts), replies
        texts = [replies[i][1]["completions"][0]["text"] for i in range(len(prompts))]
        assert texts == FakeBackend().generate(prompts)
        for i in range(len(prompts)):
            _, status = http_json("GET", "127.0.0.1", port, f"/v1/requests/kill-{i}")
            assert status["status"] == "completed"
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            _, health = http_json("GET", "127.0.0.1", port, "/healthz")
            row = {w["name"]: w for w in health["workers"]}["worker-0"]
            if row["up"] and row["pid"] != killed:
                break
            time.sleep(0.1)
        assert row["up"] and row["pid"] != killed and row["restarts"] >= 1
        assert row["failovers"] >= 1
    finally:
        rp.sigterm()
        rc = rp.wait_exit(60.0)
    assert rc == 0
    entries, sealed, _ = RequestJournal.read_state(tmp_path / "fleet" / "router")
    assert sealed and all(e.terminal for e in entries.values())
