"""Fleet observability on the port (serve/federation.py behind the port's
router): the cases of tests/test_serve_federation.py on the port's
imports and FakeBackend workers — the worker snapshot surface, the scrape
loop's clock offset and rollups, the fleet /debug/slo and /v1/usage views,
the /healthz summary block, the stitched /debug/trace (a failover's two
halves in one process), and incident bundles and their throttle — then the
JAX package's side: its ``fold_incident_bundle`` folds the port's bundles
and seeded synthetic ones into the same timeline as the port's, and the
port's worker snapshot and dump documents carry the JAX worker's keys.

A "dead" worker is a socket bound and never listened on, held for the
test's life."""
from __future__ import annotations

import json
import random
import socket
import threading
import time
import urllib.request
from contextlib import contextmanager

import pytest

from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.serve import federation as jax_federation
from vnsum_tpu.serve.server import ServeState as JaxServeState
from vnsum_tpu.serve.server import make_server as jax_make_server
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.obs.histogram import Histogram
from vnsum_tpu_torch.serve.federation import (
    INCIDENT_REASONS,
    WorkerSample,
    fold_incident_bundle,
)
from vnsum_tpu_torch.serve.router import RouterState, Worker, make_router_server
from vnsum_tpu_torch.serve.server import ServeState, make_server


@contextmanager
def dead_port():
    """A port that refuses connects for the block's life: bound, never
    listened on, and held, so nothing else can take it."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    try:
        yield sock.getsockname()[1]
    finally:
        sock.close()


def _spawn_worker(name: str, **kw):
    state = ServeState(FakeBackend(), max_batch=8, max_wait_s=0.005, **kw)
    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return Worker(name, "127.0.0.1", server.server_address[1]), \
        (server, state, thread)


def _mark_up(state: RouterState) -> None:
    with state._lock:
        for w in state.workers:
            w.up = True
        state._replay_started = state._replay_done = True


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture()
def fedfleet(tmp_path):
    """Two in-process workers (one with an SLO engine) behind a router
    with federation + incident capture ON, probe loop OFF — scrapes run
    deterministically via scrape_all(). Yields (base, router, workers,
    handles)."""
    w0, h0 = _spawn_worker("w0", slo="e2e_p99=30,availability=0.9")
    w1, h1 = _spawn_worker("w1")
    state = RouterState(
        [w0, w1],
        journal_dir=tmp_path / "router",
        tenants={"alpha": "interactive", "beta": "batch"},
        incident_dir=tmp_path / "incidents",
        incident_min_interval_s=0.0,
    )
    _mark_up(state)
    server = make_router_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield (f"http://127.0.0.1:{server.server_address[1]}", state,
           [w0, w1], (h0, h1))
    server.shutdown()
    server.server_close()
    state.close(drain_timeout_s=2.0)
    for server_, sstate, _t in (h0, h1):
        server_.shutdown()
        server_.server_close()
        sstate.close()


# -- worker snapshot surface ---------------------------------------------------


def test_worker_obs_snapshot_surface(fedfleet):
    base, _state, workers, _handles = fedfleet
    w = workers[0]
    _post(f"http://{w.host}:{w.port}/v1/generate",
          {"prompt": "bản tin quan trắc", "request_id": "obs-1"})
    # the worker finishes its request trace in the handler's finally —
    # after the response bytes — so poll for the finished span briefly
    deadline = time.monotonic() + 5.0
    while True:
        status, snap = _get_json(
            f"http://{w.host}:{w.port}/debug/obs/snapshot")
        if any(t["trace_id"] == "obs-1" for t in snap.get("traces", [])) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert status == 200
    assert snap["ready"] is True and snap["readyz_reason"] == "ready"
    assert 0.0 < snap["mono_now"] <= time.monotonic()
    assert snap["counters"]["requests_total"] >= 1
    assert "e2e_seconds" in snap["hists"] and "ttft_seconds" in snap["hists"]
    # this worker runs an SLO engine — the federation payload carries it
    assert snap["slo"]["breached"] is False
    assert "availability" in snap["slo"]["objectives"]
    assert any(t["trace_id"] == "obs-1" for t in snap["traces"])
    assert snap["watchdog"]["max_heartbeat_age_s"] >= 0.0


# -- federation scrape + rollups -----------------------------------------------


def test_scrape_estimates_clock_offset_and_rolls_up(fedfleet):
    base, state, workers, _handles = fedfleet
    for i in range(4):
        _post(base + "/v1/generate",
              {"prompt": f"tin số {i}", "request_id": f"roll-{i}"})
    fed = state.federation
    fed.scrape_all()
    # same-process monotonic clocks: the RTT-midpoint offset estimate must
    # land within the scrape round trip of zero
    for name in ("w0", "w1"):
        s = fed.sample(name)
        assert s is not None and s.error is None
        assert abs(s.clock_offset_s) <= s.scrape_s + 0.01
    rollup = fed.fleet_rollup()
    # counters summed across the roster == what the workers report
    per_worker_total = 0
    for _w, (_srv, sstate, _t) in zip(workers, _handles):
        per_worker_total += sstate.metrics.federation_snapshot()[
            "counters"]["requests_total"]
    assert rollup["counters"]["requests_total"] == per_worker_total >= 4
    # histograms merged, not averaged: fleet e2e count == sum of workers
    assert rollup["hists"]["e2e_seconds"].count == per_worker_total
    # gauges stay per-worker
    for name in ("w0", "w1"):
        row = rollup["per_worker"][name]
        assert row["ready"] is True and row["stale"] is False
        assert "queue_depth" in row and "clock_offset_s" in row
    assert "slo_burn_fast_max" in rollup["per_worker"]["w0"]


def test_scrape_error_keeps_previous_payload(fedfleet):
    _base, state, _workers, _handles = fedfleet
    fed = state.federation
    fed.scrape_all()
    with dead_port() as port:
        dead = Worker("ghost", "127.0.0.1", port)
        s = fed.scrape_one(dead)
        assert s.error is not None and s.payload is None
        # a never-scraped-successfully worker contributes a stale row, while
        # a previously-good worker keeps its last payload on a refused scrape
        good = fed.sample("w0")
        real_w0 = next(w for w in state.workers if w.name == "w0")
        bad_w0 = Worker("w0", "127.0.0.1", port)
        s2 = fed.scrape_one(bad_w0)
    assert s2.error is not None
    assert s2.payload is not None  # previous good payload retained
    assert s2.payload is good.payload
    fed.scrape_one(real_w0)  # restore


def test_histogram_merge_skew_skipped_and_counted(fedfleet):
    _base, state, _workers, _handles = fedfleet
    fed = state.federation
    fed.scrape_all()
    # a version-skewed worker on a different bucket ladder: its hists are
    # skipped (never mis-binned), counted into merge_errors
    skewed = Histogram((0.5, 1.0))
    skewed.observe(0.2)
    payload = {
        "mono_now": time.monotonic(), "ready": True,
        "readyz_reason": "ready", "queue_depth": 0,
        "counters": {"requests_total": 1},
        "hists": {"e2e_seconds": skewed.state_dict()},
    }
    with fed._lock:
        fed._samples["zz-skew"] = WorkerSample(
            "zz-skew", payload, time.monotonic(), 0.001, 0.0, None)
    before = fed.stats_dict()["merge_errors"]
    rollup = fed.fleet_rollup()
    assert fed.stats_dict()["merge_errors"] == before + 1
    # the skewed worker's counters still sum; its buckets do not
    assert rollup["counters"]["requests_total"] >= 1
    assert rollup["hists"]["e2e_seconds"].bounds != skewed.bounds
    with fed._lock:
        del fed._samples["zz-skew"]


# -- fleet /debug/slo + /v1/usage ----------------------------------------------


def test_fleet_slo_view_attributes_burn(fedfleet):
    base, state, _workers, _handles = fedfleet
    _post(base + "/v1/generate", {"prompt": "đo lường slo"})
    state.federation.scrape_all()
    status, slo = _get_json(base + "/debug/slo")
    assert status == 200
    assert slo["role"] == "router" and slo["breached"] is False
    # only w0 runs an SLO engine — attribution lists exactly it
    assert [r["worker"] for r in slo["burn_attribution"]] == ["w0"]
    assert slo["workers"]["w0"]["stale"] is False
    assert "objectives" in slo["workers"]["w0"]
    assert slo["workers"]["w1"]["slo"] is None


def test_fleet_usage_sums_tenants_and_maxes_quantiles(fedfleet):
    base, state, _workers, _handles = fedfleet
    for i in range(3):
        _post(base + "/v1/generate", {"prompt": f"dùng {i}"},
              headers={"X-Tenant": "alpha"})
    state.federation.scrape_all()
    status, usage = _get_json(base + "/v1/usage")
    assert status == 200 and usage["role"] == "router"
    tenants = usage["tenants"]
    total = sum(row.get("requests", 0) for row in tenants.values())
    assert total >= 3
    # summed counters equal the per-worker breakdown the view also ships
    per_worker = sum(
        row.get("requests", 0)
        for wrows in usage["workers"].values() for row in wrows.values()
    )
    assert total == per_worker
    # quantile merge is the conservative max, never a sum: each merged
    # quantile equals some worker's quantile
    for tenant, row in tenants.items():
        e2e = row.get("e2e")
        if not e2e or not e2e.get("count"):
            continue
        worker_p95 = [
            wrows[tenant]["e2e"]["p95_s"]
            for wrows in usage["workers"].values() if tenant in wrows
        ]
        assert e2e["p95_s"] == pytest.approx(max(worker_p95))


# -- /healthz per-worker summary -----------------------------------------------


def test_healthz_carries_worker_summary_block(fedfleet):
    base, state, _workers, _handles = fedfleet
    _post(base + "/v1/generate", {"prompt": "khối tóm tắt"})
    state.federation.scrape_all()
    status, health = _get_json(base + "/healthz")
    assert status == 200
    rows = {r["name"]: r for r in health["workers"]}
    for name in ("w0", "w1"):
        s = rows[name]["summary"]
        assert s["ready"] is True and s["readyz"] == "ready"
        assert s["rung"] == 0
        assert s["inflight"] == 0
        assert s["watchdog_max_heartbeat_age_s"] >= 0.0
        assert s["last_markdown_reason"] == ""
        assert s["sample_age_s"] is not None
    assert health["federation"]["scrapes"] >= 2
    assert health["incidents"] == {}


# -- merged trace stitching ----------------------------------------------------


def _trace_processes(doc: dict) -> dict[str, dict]:
    """process_name -> {"pid", "thread_names", "spans"} from a merged
    Chrome trace."""
    procs: dict[int, dict] = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "M" and e["name"] == "process_name":
            procs.setdefault(e["pid"], {"name": e["args"]["name"],
                                        "thread_names": set(), "spans": []})
    for e in doc["traceEvents"]:
        p = procs.get(e["pid"])
        if p is None:
            continue
        if e["ph"] == "M" and e["name"] == "thread_name":
            p["thread_names"].add(e["args"]["name"])
        elif e["ph"] == "X":
            p["spans"].append(e)
    return {p["name"]: p for p in procs.values()}


def test_debug_trace_stitches_router_and_worker_spans(fedfleet):
    base, _state, _workers, _handles = fedfleet
    # a FAN-OUT request: two prompts journal as st-1 + st-1#1 and fan out
    # per-prompt sub-tracks on the worker — exactly the shape whose spans
    # straddle processes
    _post(base + "/v1/generate",
          {"prompts": ["ghép dấu vết liên tiến trình",
                       "nhánh song song thứ hai"],
           "request_id": "st-1"})
    # the worker half finishes just after the response bytes — retry the
    # stitch until both sources contribute
    deadline = time.monotonic() + 5.0
    while True:
        status, doc = _get_json(base + "/debug/trace")
        procs = _trace_processes(doc)
        p = procs.get("request st-1")
        srcs = ({sp["args"]["source"] for sp in p["spans"]}
                if p else set())
        if len(srcs) >= 2 or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert status == 200
    p = procs["request st-1"]
    # ONE Perfetto process holds the router hop AND the worker hop
    sources = {sp["args"]["source"] for sp in p["spans"]}
    assert "router" in sources and sources & {"w0", "w1"}
    assert "router:request" in p["thread_names"]
    assert any(t.endswith(":request") and not t.startswith("router")
               for t in p["thread_names"])
    # the fan-out's per-prompt sub-tracks ride along under the same pid
    assert any(":prompt " in t for t in p["thread_names"])
    # the worker half carries the router's propagated parent span
    worker_spans = [sp for sp in p["spans"]
                    if sp["args"]["source"] != "router"]
    assert any(sp["args"].get("parent_span") == "router:st-1"
               for sp in worker_spans)
    # offsets applied: every span lands at a non-negative rebased ts
    assert all(sp["ts"] >= 0 for sp in p["spans"])


def test_debug_trace_failover_halves_share_one_trace_id(tmp_path):
    """The acceptance trace: a request whose first hop dies mid-flight is
    replayed onto the survivor, and the merged /debug/trace shows BOTH the
    failed proxy attempt (router span, outcome=failover) and the
    survivor's worker spans under one Perfetto process."""
    import zlib

    live, handle = _spawn_worker("live")
    dead_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead_sock.bind(("127.0.0.1", 0))
    dead = Worker("dead", "127.0.0.1", dead_sock.getsockname()[1])
    state = RouterState([dead, live], journal_dir=tmp_path / "router",
                        incident_dir=tmp_path / "incidents",
                        incident_min_interval_s=0.0)
    _mark_up(state)
    server = make_router_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        hint = next(
            h for h in (f"hint-{i}" for i in range(1000))
            if max([dead, live], key=lambda w: zlib.crc32(
                f"{h}|{w.name}".encode())).name == "dead"
        )
        status, body, _ = _post(
            base + "/v1/generate",
            {"prompt": "nửa trước và nửa sau", "cache_hint": hint,
             "request_id": "fo-trace"})
        assert status == 200
        deadline = time.monotonic() + 5.0
        while True:
            s, doc = _get_json(base + "/debug/trace")
            procs = _trace_processes(doc)
            p = procs.get("request fo-trace")
            # both halves: the router finishes its own trace after the
            # response bytes, as the survivor does
            if (p and any(sp["args"]["source"] == "live"
                          for sp in p["spans"])
                    and any(sp["args"]["source"] == "router"
                            for sp in p["spans"])) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        assert s == 200
        p = procs["request fo-trace"]
        router_spans = [sp for sp in p["spans"]
                        if sp["args"]["source"] == "router"]
        assert any(sp["name"] == "proxy"
                   and sp["args"].get("outcome") == "failover"
                   for sp in router_spans)
        # the survivor's post-failover half sits in the SAME process
        assert any(sp["args"]["source"] == "live" for sp in p["spans"])
        # the death also fired a failover incident with a bundle on disk
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            bundles = list((tmp_path / "incidents").glob("inc_*"))
            if bundles and (bundles[0] / "manifest.json").exists():
                break
            time.sleep(0.05)
        assert state.incidents.counts_snapshot().get("failover", 0) >= 1
    finally:
        server.shutdown()
        server.server_close()
        state.close(drain_timeout_s=2.0)
        handle[0].shutdown()
        handle[0].server_close()
        handle[1].close()
        dead_sock.close()


# -- incident capture ----------------------------------------------------------


def test_operator_incident_bundle_and_timeline(fedfleet, tmp_path):
    base, state, _workers, _handles = fedfleet
    for i in range(3):
        _post(base + "/v1/generate",
              {"prompt": f"sự cố {i}", "request_id": f"inc-{i}"})
    state.federation.scrape_all()
    inc = state.incidents.trigger("operator", detail="test trigger",
                                  sync=True)
    assert inc is not None and inc.startswith("inc_")
    bundle = tmp_path / "incidents" / inc
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert manifest["incident"] == inc
    assert manifest["reason"] == "operator"
    assert manifest["workers_collected"] == 2
    for name in ("w0", "w1"):
        entry = manifest["workers"][name]
        assert entry["file"] == f"worker_{name}.json"
        assert "clock_offset_s" in entry
        wdoc = json.loads((bundle / entry["file"]).read_text())
        assert wdoc["source"] == name and wdoc["incident"] == inc
        assert wdoc["stacks"]
        assert wdoc["flightrecorder"]["events"]  # dispatch events
    rdoc = json.loads((bundle / "router.json").read_text())
    assert rdoc["source"] == "router"
    assert any(e["kind"] == "incident" and e.get("incident") == inc
               for e in rdoc["flightrecorder"]["events"])
    # folded timeline: events from router + both workers, monotone wall
    report = fold_incident_bundle(bundle)
    assert report["incident"] == inc
    assert set(report["sources"]) == {"router", "w0", "w1"}
    assert all(report["sources"][s]["events"] > 0
               for s in ("router", "w0", "w1"))
    walls = [e["wall"] for e in report["events"]]
    assert walls == sorted(walls) and walls
    # the JAX package's report CLI renders the port's bundle, folded by
    # the JAX package into the same timeline
    from scripts.incident_report import main as report_main, render_text
    assert jax_federation.fold_incident_bundle(bundle) == report
    text = render_text(report, limit=10)
    assert inc in text and "router" in text
    assert report_main([str(bundle)]) == 0
    # routing decisions appear in the merged timeline
    assert any(e["source"] == "router" and e["kind"] == "route"
               for e in report["events"])
    # the fired incident shows up on /healthz and /metrics
    _s, health = _get_json(base + "/healthz")
    assert health["incidents"]["operator"] >= 1
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    assert 'vnsum_serve_fleet_incidents_total{reason="operator"} 1' in text


def test_incident_throttle_and_disabled_paths(fedfleet, tmp_path):
    _base, state, _workers, _handles = fedfleet
    assert set(INCIDENT_REASONS) == {"slo_fast_burn", "markdown",
                                     "failover", "operator"}
    state.incidents.min_interval_s = 60.0
    first = state.incidents.trigger("markdown", detail="w0: probe",
                                    sync=True)
    assert first is not None
    # same reason inside the throttle window: dropped
    assert state.incidents.trigger("markdown", sync=True) is None
    # a different reason is NOT throttled by markdown's stamp
    assert state.incidents.trigger("operator", sync=True) is not None
    assert state.incidents.counts_snapshot()["markdown"] == 1
    # no incident_dir -> triggers are a typed no-op
    from vnsum_tpu_torch.serve.federation import IncidentManager
    off = IncidentManager(state, state.federation, None)
    assert off.trigger("operator", sync=True) is None


# -- the JAX package's side ------------------------------------------------------


def _synthetic_bundle(root, seed: int):
    """A bundle of seeded rings: the router's and 1-4 workers', events at
    random offsets from each process's own anchor, one worker without a
    file (unreachable) and one with an empty ring."""
    rng = random.Random(seed)
    bundle = root / f"inc_{seed}"
    bundle.mkdir()
    kinds = ("route", "admit", "dispatch", "complete", "markdown", "failover")

    def ring(n):
        anchor = 1.7e9 + rng.uniform(0, 100)
        return {"started_wall": anchor, "events_dropped": rng.randrange(3),
                "events": [{"seq": i, "t_rel": round(rng.uniform(0, 60), 6),
                            "kind": rng.choice(kinds), "rid": f"r{rng.randrange(9)}"}
                           for i in range(n)]}

    (bundle / "router.json").write_text(json.dumps(
        {"source": "router", "flightrecorder": ring(rng.randrange(1, 30))}))
    workers = {}
    for i in range(rng.randint(1, 4)):
        name = f"worker-{i}"
        if i == 1:
            workers[name] = {"host": "127.0.0.1", "port": 1, "error": "refused"}
            continue
        workers[name] = {"host": "127.0.0.1", "port": 1, "file": f"worker_{name}.json"}
        doc = {"source": name, "flightrecorder": ring(rng.randrange(0, 30)) if i else None}
        (bundle / f"worker_{name}.json").write_text(json.dumps(doc))
    (bundle / "manifest.json").write_text(json.dumps(
        {"incident": f"inc_{seed}", "reason": rng.choice(INCIDENT_REASONS),
         "detail": "seeded", "wall": 1.7e9, "workers": workers}))
    return bundle


@pytest.mark.parametrize("seed", range(4))
def test_fold_incident_bundle_equal_jax(seed, tmp_path):
    bundle = _synthetic_bundle(tmp_path, seed)
    report = fold_incident_bundle(bundle)
    assert report == jax_federation.fold_incident_bundle(bundle)
    walls = [e["wall"] for e in report["events"]]
    assert walls == sorted(walls)
    assert "worker-1" not in report["sources"]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("watchdog", "counters", "hists", "usage",
                                             "objectives"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_worker_snapshot_and_dump_keys_equal_jax(tmp_path):
    """The worker half the federation reads: the port's
    /debug/obs/snapshot and /debug/dump documents carry the JAX worker's
    keys after the same requests (with an SLO engine and tenants on)."""
    kw = dict(slo="e2e_p99=30,availability=0.9")
    port = _spawn_worker("p", **kw)
    jstate = JaxServeState(JaxFakeBackend(), max_batch=8, max_wait_s=0.005, **kw)
    jserver = jax_make_server(jstate, "127.0.0.1", 0)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    bases = [f"http://{port[0].host}:{port[0].port}",
             f"http://127.0.0.1:{jserver.server_address[1]}"]
    try:
        docs = []
        for base in bases:
            for i in range(3):
                _post(base + "/v1/generate", {"prompt": f"tin {i}", "request_id": f"k-{i}"})
            time.sleep(0.1)  # the last trace finishes after its response bytes
            _s, snap = _get_json(base + "/debug/obs/snapshot")
            _s2, dump, _h = _post(base + "/debug/dump?incident=inc_1", {})
            docs.append((snap, dump))
        (sp, dp), (sj, dj) = docs
        assert _keys(sp) == _keys(sj)
        assert set(sp["counters"]) == set(sj["counters"])
        assert set(sp["hists"]) == set(sj["hists"])
        assert sp["counters"] == sj["counters"]
        assert _keys(dp) == _keys(dj)
        assert dp["incident"] == dj["incident"] == "inc_1"
    finally:
        port[1][0].shutdown()
        port[1][0].server_close()
        port[1][1].close()
        jserver.shutdown()
        jserver.server_close()
        jstate.close()
