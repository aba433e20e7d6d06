"""The port's serving layer against the JAX package's, on their FakeBackends:
the same request sequences through both HTTP servers give equal texts,
status codes and shed reasons, equal /healthz keys and /metrics metric
names; the metric registries (less the families of modules not ported
yet), the histogram ladders and the quantiles of the same observations are
equal."""
from __future__ import annotations

import http.client
import json
import random
import threading
import urllib.parse

import pytest

from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.obs import histogram as jax_histogram
from vnsum_tpu.obs.window import WindowedHistogram as JaxWindowedHistogram
from vnsum_tpu.serve import metrics as jax_metrics
from vnsum_tpu.serve.server import ServeState as JaxServeState
from vnsum_tpu.serve.server import make_server as jax_make_server
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.obs import histogram
from vnsum_tpu_torch.obs.window import WindowedHistogram
from vnsum_tpu_torch.serve import metrics
from vnsum_tpu_torch.serve.server import ServeState, make_server

DOC = "\n\n".join(
    f"Đoạn văn {i}: " + "nội dung tiếng Việt có dấu thanh. " * 25
    for i in range(4)
)
LONG_DOC = "\n\n".join(
    f"Phần {i}: " + "văn bản dài cần tóm tắt qua nhiều vòng. " * 220
    for i in range(12)
)
APPROACHES = ("mapreduce", "mapreduce_critique", "iterative", "truncated",
              "mapreduce_hierarchical", "skeleton")


def _start(state_cls, server_fn, backend, **kw):
    state = state_cls(backend, max_batch=8, max_wait_s=0.005, **kw)
    server = server_fn(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}", state, server


@pytest.fixture(params=[False, True], ids=["batch", "inflight"])
def pair(request):
    """(port base, JAX base): one server of each package, same settings."""
    kw = dict(inflight=request.param, slots=4 if request.param else None)
    port = _start(ServeState, make_server, FakeBackend(), **kw)
    jax = _start(JaxServeState, jax_make_server, JaxFakeBackend(), **kw)
    yield port[0], jax[0]
    for _base, state, server in (port, jax):
        server.shutdown()
        server.server_close()
        state.close()


def _req(base, method, path, body=None, headers=None):
    """(status, decoded JSON or raw text) over one HTTP exchange; ``body``
    may be a dict (sent as JSON) or raw bytes."""
    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw.decode()
    finally:
        conn.close()


def _both(pair, method, path, body=None, headers=None):
    return [_req(base, method, path, body, headers) for base in pair]


def _strip_timing(d):
    """The parts of a reply both packages must agree on: everything but
    clocks, ids and per-process counters."""
    if isinstance(d, dict):
        return {k: _strip_timing(v) for k, v in d.items()
                if k not in ("serving", "record", "records", "request_id", "trace_id")}
    if isinstance(d, list):
        return [_strip_timing(x) for x in d]
    return d


GENERATE_CASES = [
    {"prompt": "<content>\nxin chào thế giới tươi đẹp\n</content>"},
    {"prompts": ["<content>\nmột hai ba\n</content>", "không có khối nào", "x y z"]},
    {"prompt": "tóm tắt " * 60, "max_new_tokens": 16},
    {"prompt": "<content>\nnhiệt độ mẫu\n</content>", "temperature": 0.7, "seed": 3},
    {"prompt": "có tham chiếu", "reference": "tham chiếu gốc"},
    {"prompt": "có gợi ý bộ nhớ đệm", "cache_hint": "có gợi ý"},
]


@pytest.mark.parametrize("case", range(len(GENERATE_CASES)))
def test_generate_texts_and_statuses_equal(pair, case):
    (sp, bp), (sj, bj) = _both(pair, "POST", "/v1/generate", GENERATE_CASES[case])
    assert sp == sj == 200
    assert [c["text"] for c in bp["completions"]] == [c["text"] for c in bj["completions"]]
    assert _strip_timing(bp).keys() == _strip_timing(bj).keys()


@pytest.mark.parametrize("approach", APPROACHES)
def test_summarize_equal(pair, approach):
    doc = LONG_DOC if approach in ("mapreduce", "mapreduce_critique") else DOC
    (sp, bp), (sj, bj) = _both(pair, "POST", "/v1/summarize",
                               {"text": doc, "approach": approach})
    assert sp == sj == 200
    assert _strip_timing(bp) == _strip_timing(bj)
    assert bp["summary"]


SHED_AND_ERROR_CASES = [
    ("POST", "/v1/generate", {"prompt": "hết hạn", "deadline_ms": 0}),
    ("POST", "/v1/summarize", {"text": DOC, "deadline_ms": 0}),
    ("POST", "/v1/generate", {"prompt": "x", "temperatre": 1}),
    ("POST", "/v1/generate", {"prompts": []}),
    ("POST", "/v1/generate", {"prompt": "x", "max_new_tokens": "nhiều"}),
    ("POST", "/v1/generate", {"prompt": "x", "top_p": float("nan")}),
    ("POST", "/v1/generate", {"prompts": ["a", "b"], "stream": True}),
    ("POST", "/v1/summarize", {"text": "   "}),
    ("POST", "/v1/summarize", {"text": DOC, "approach": "không-có"}),
    ("POST", "/v1/generate", b"{not json"),
    ("POST", "/v1/generate", b"\xff\xfe"),
    ("GET", "/v1/requests/khong-ton-tai", None),
    ("DELETE", "/v1/requests/khong-ton-tai", None),
    ("GET", "/khong-co-duong-nay", None),
    ("POST", "/khong-co-duong-nay", {"a": 1}),
    ("GET", "/readyz", None),
]


@pytest.mark.parametrize("case", range(len(SHED_AND_ERROR_CASES)))
def test_sheds_and_errors_equal(pair, case):
    method, path, body = SHED_AND_ERROR_CASES[case]
    (sp, bp), (sj, bj) = _both(pair, method, path, body)
    assert sp == sj
    if isinstance(bp, dict) and "reason" in bp:
        assert bp["reason"] == bj["reason"]  # the shed reason
    if isinstance(bp, dict):
        assert bp.get("error") == bj.get("error") or (
            isinstance(bp.get("error"), str) and isinstance(bj.get("error"), str))
        assert set(bp) == set(bj)


def test_stream_events_equal(pair):
    payload = {"prompt": "<content>\nluồng sự kiện từng đoạn một nhé\n</content>",
               "stream": True}
    events = []
    for base in pair:
        status, raw = _req(base, "POST", "/v1/generate", payload)
        assert status == 200
        evs = []
        for frame in raw.split("\n\n"):
            name = data = None
            for line in frame.splitlines():
                if line.startswith("event: "):
                    name = line[len("event: "):]
                elif line.startswith("data: "):
                    data = json.loads(line[len("data: "):])
            if name:
                evs.append((name, data))
        text = "".join(d["text"] for n, d in evs if n == "delta")
        done = [d for n, d in evs if n == "done"][0]
        assert text == done["completions"][0]["text"]
        events.append((text, [n for n, _ in evs if n != "delta"]))
    assert events[0] == events[1]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("watchdog",):
            out |= _keys(v, prefix + k + ".")
    return out


def test_healthz_keys_equal(pair):
    (sp, bp), (sj, bj) = _both(pair, "GET", "/healthz")
    assert sp == sj == 200
    assert _keys(bp) == _keys(bj)
    assert bp["status"] == bj["status"] == "ok"


# families of the JAX modules not ported yet: the serving mesh (ROADMAP A10);
# the journal, tenant quotas and tier preemption, SLOs and the fleet (A15b)
UNPORTED_PREFIXES = ("mesh_", "journal_", "slo_", "router_", "federation_",
                     "fleet_")
UNPORTED_NAMES = {"qos_tenants", "qos_requests_total", "qos_quota_sheds_total",
                  "qos_bucket_tokens", "gang_preemptions_total"}


def _unported(name: str) -> bool:
    base = name.removeprefix("vnsum_serve_")
    return base.startswith(UNPORTED_PREFIXES) or base in UNPORTED_NAMES


def _metric_names(text: str) -> set[str]:
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_metrics_names_equal_after_traffic(pair):
    for base in pair:
        _req(base, "POST", "/v1/generate", {"prompt": "làm nóng máy chủ"})
        _req(base, "POST", "/v1/generate", {"prompt": "hết hạn", "deadline_ms": 0})
    (sp, tp), (sj, tj) = _both(pair, "GET", "/metrics")
    assert sp == sj == 200
    assert _metric_names(tp) == {n for n in _metric_names(tj) if not _unported(n)}
    (_, up), (_, uj) = _both(pair, "GET", "/v1/usage")
    assert _keys(up) == _keys(uj)


@pytest.mark.parametrize("full", [True, False])
def test_metric_registry_equal(full):
    jax_names = jax_metrics.metric_names(full)
    assert metrics.metric_names(full) == [n for n in jax_names if not _unported(n)]
    # the exclusions name only families the JAX registry really has
    assert all(any(_unported(n) and n.endswith(u) for n in jax_names)
               for u in UNPORTED_NAMES)


@pytest.mark.parametrize("ladder", [
    "WAIT_BUCKETS_S", "TTFT_BUCKETS_S", "E2E_BUCKETS_S", "OCCUPANCY_BUCKETS",
    "ACCEPT_BUCKETS", "SCRAPE_BUCKETS_S",
])
def test_histogram_ladders_equal(ladder):
    assert getattr(histogram, ladder) == getattr(jax_histogram, ladder)


@pytest.mark.parametrize("seed", range(4))
def test_histogram_quantiles_equal(seed):
    rng = random.Random(seed)
    bounds = histogram.TTFT_BUCKETS_S
    hp = histogram.Histogram(bounds)
    hj = jax_histogram.Histogram(bounds)
    wp = WindowedHistogram(bounds, horizon_s=60.0, sub_windows=6)
    wj = JaxWindowedHistogram(bounds, horizon_s=60.0, sub_windows=6)
    for i in range(500):
        v = rng.lognormvariate(-2.0, 1.5)
        for h in (hp, hj):
            h.observe(v)
        for w in (wp, wj):
            w.observe(v, now=100.0 + i * 0.01)
    assert hp.to_dict() == hj.to_dict()
    assert hp.render("x_seconds", "help") == hj.render("x_seconds", "help")
    mp = wp.merged(now=105.0)
    mj = wj.merged(now=105.0)
    for q in (0.5, 0.9, 0.95, 0.99):
        assert hp.percentile(q) == hj.percentile(q)
        assert mp.percentile(q) == mj.percentile(q)
