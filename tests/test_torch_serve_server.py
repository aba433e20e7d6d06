"""The port's serving HTTP front-end over a live ThreadingHTTPServer with
the FakeBackend (tests/test_serve_server.py's cases that need no journal
and no mesh): /v1/generate, /v1/summarize, /healthz, /metrics, and the
typed 429 shed contract; the unported features' refusals."""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest

from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.serve.server import ServeState, make_server

DOC = "\n\n".join(
    f"Đoạn văn {i}: " + "nội dung tiếng Việt có dấu thanh. " * 25
    for i in range(4)
)


@pytest.fixture()
def serve_url():
    state = ServeState(FakeBackend(), max_batch=8, max_wait_s=0.005)
    server = make_server(state, "127.0.0.1", 0)  # ephemeral port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()
    state.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz(serve_url):
    base, _ = serve_url
    status, body = _get(base + "/healthz")
    d = json.loads(body)
    assert status == 200
    assert d["status"] == "ok" and d["backend"] == "fake"
    assert d["queue_depth"] == 0 and d["closed"] is False


def test_healthz_schema_regression(serve_url):
    """The /healthz response schema is a contract probes parse: the
    uptime/version/start-stamp fields must keep their names and
    types, and the SLO line appears exactly when --slo is configured."""
    import re

    base, _ = serve_url
    _, body = _get(base + "/healthz")
    d = json.loads(body)
    # field presence + types
    assert isinstance(d["uptime_s"], (int, float)) and d["uptime_s"] >= 0
    assert isinstance(d["version"], str) and d["version"]
    from vnsum_tpu_torch import __version__

    assert d["version"] == __version__
    # start wall-clock stamp: ISO seconds resolution, explicitly UTC
    assert re.fullmatch(r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}Z",
                        d["started_at"])
    # no --slo -> no slo line (probes must not see a phantom verdict)
    assert "slo" not in d
    # uptime advances between polls
    import time as _time

    _time.sleep(0.05)
    _, body = _get(base + "/healthz")
    assert json.loads(body)["uptime_s"] >= d["uptime_s"]


def test_generate_single_and_batch(serve_url):
    base, state = serve_url
    status, d = _post(base + "/v1/generate", {"prompt": "xin chào " * 10})
    assert status == 200
    (c,) = d["completions"]
    assert c["text"]
    assert c["record"]["status"] == "ok" and c["record"]["batch_size"] >= 1
    status, d = _post(
        base + "/v1/generate", {"prompts": ["một " * 8, "hai " * 8]}
    )
    assert status == 200 and len(d["completions"]) == 2


def test_generate_validation(serve_url):
    base, _ = serve_url
    for payload in ({}, {"prompt": ""}, {"prompts": []}, {"prompts": [1]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/v1/generate", payload)
        assert exc.value.code == 400


def test_bad_numeric_fields_are_400_not_engine_errors(serve_url):
    # type-bad knobs must be rejected at the door (400), not forwarded into
    # the scheduler where they'd fail the batch and count as engine errors
    base, state = serve_url
    for payload in (
        {"prompt": "x", "temperature": "hot"},
        {"prompt": "x", "deadline_ms": "soon"},
        {"prompt": "x", "max_new_tokens": "many"},
        {"prompt": "x", "max_new_tokens": 1.5},
        {"prompt": "x", "top_k": True},
    ):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/v1/generate", payload)
        assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/summarize", {"text": DOC, "max_new_tokens": "many"})
    assert exc.value.code == 400
    stats = state.scheduler.metrics.snapshot()
    assert stats.errors == 0 and stats.submitted == 0


def test_generate_expired_deadline_is_429_shed(serve_url):
    base, _ = serve_url
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/generate",
              {"prompt": "trễ hạn " * 5, "deadline_ms": 0})
    assert exc.value.code == 429
    body = json.loads(exc.value.read())
    assert body["error"] == "shed" and body["reason"] == "deadline"
    # even sheds carry the correlation id (request-id plumbing)
    assert body["request_id"]


def test_summarize_full_strategy_with_serving_record(serve_url):
    base, _ = serve_url
    status, d = _post(
        base + "/v1/summarize", {"text": DOC, "approach": "mapreduce"}
    )
    assert status == 200
    assert d["approach"] == "mapreduce" and d["summary"]
    assert d["num_chunks"] >= 1 and d["llm_calls"] >= 1
    assert d["serving"]["llm_requests"] == d["llm_calls"]
    assert d["serving"]["engine_s"] >= 0
    assert d["serving"]["generated_tokens"] > 0


def test_summarize_max_new_tokens_override(serve_url):
    base, state = serve_url
    # the override builds an uncached strategy carrying the budget; the
    # shared per-approach cache stays on the approach default
    status, d = _post(
        base + "/v1/summarize",
        {"text": DOC, "approach": "mapreduce", "max_new_tokens": 77},
    )
    assert status == 200 and d["summary"]
    strat = state.strategy_for("mapreduce", 77)
    assert strat.max_new_tokens == 77
    assert state.strategy_for("mapreduce").max_new_tokens != 77


def test_summarize_validation(serve_url):
    base, _ = serve_url
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/summarize", {"text": "   "})
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/summarize", {"text": "x", "approach": "nope"})
    assert exc.value.code == 400
    assert "approaches" in json.loads(exc.value.read())


def test_concurrent_summarize_requests_share_engine_batches():
    # own server with a WIDE coalescing window: the assertion is about
    # packing, and the handler threads racing to submit must not lose to
    # scheduler flushes on a slow/throttled CI host (5ms flaked there)
    state = ServeState(FakeBackend(), max_batch=8, max_wait_s=0.25)
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        n = 4
        barrier = threading.Barrier(n)
        out = [None] * n

        def worker(i):
            barrier.wait()
            out[i] = _post(
                base + "/v1/summarize", {"text": DOC, "approach": "truncated"}
            )

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(status == 200 and d["summary"] for status, d in out)
        # truncated = 1 LLM call per request; the scheduler should have
        # packed the 4 concurrent calls into fewer dispatches than requests
        assert len(state.backend.batch_sizes) < n
        assert sum(state.backend.batch_sizes) == n
    finally:
        server.shutdown()
        server.server_close()
        state.close()


def test_metrics_endpoint_exposes_serving_counters(serve_url):
    base, _ = serve_url
    _post(base + "/v1/generate", {"prompt": "đo lường " * 6})
    status, body = _get(base + "/metrics")
    text = body.decode()
    assert status == 200
    assert "vnsum_serve_requests_total" in text
    assert "vnsum_serve_batches_total" in text
    assert "vnsum_serve_engine_seconds_total" in text
    assert 'vnsum_serve_requests_shed_total{reason="queue_full"}' in text
    assert "vnsum_serve_queue_wait_seconds_count" in text


def test_unknown_routes_404(serve_url):
    base, _ = serve_url
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base + "/nope")
    assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/v1/nope", {})
    assert exc.value.code == 404


# -- malformed-body hardening (typed 400s, never the 500 engine path) --------


def _raw_post(base, path, body: bytes, content_length: int | None = None):
    """POST with full control over the bytes and the Content-Length header
    (urllib always sets a correct length, which several of these cases must
    violate on purpose). Returns (status, parsed-or-raw body)."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Type", "application/json")
        conn.putheader(
            "Content-Length",
            str(len(body) if content_length is None else content_length),
        )
        conn.endheaders()
        conn.send(body)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw
    finally:
        conn.close()


def test_invalid_utf8_body_is_400(serve_url):
    # json.loads raises UnicodeDecodeError (not JSONDecodeError) here; an
    # uncaught one used to surface as a 500
    base, _ = serve_url
    status, body = _raw_post(base, "/v1/generate", b'{"prompt": "\xff\xfe"}')
    assert status == 400
    assert "UTF-8" in body["error"]


def test_invalid_json_body_is_400(serve_url):
    base, _ = serve_url
    status, body = _raw_post(base, "/v1/generate", b'{"prompt": "x"')
    assert status == 400
    assert body["error"] == "invalid JSON"


def test_oversized_declared_body_is_413_typed(serve_url):
    # refused on the DECLARED length, before buffering a byte
    base, _ = serve_url
    status, body = _raw_post(
        base, "/v1/generate", b"{}", content_length=64 * 1024 * 1024
    )
    assert status == 413
    assert body["error"] == "request body too large"


def test_unknown_fields_are_400_with_the_field_named(serve_url):
    base, state = serve_url
    for path, payload in (
        ("/v1/generate", {"prompt": "x " * 4, "temperatre": 0.5}),
        ("/v1/summarize", {"text": "x " * 4, "aproach": "mapreduce"}),
    ):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + path, payload)
        assert exc.value.code == 400
        err = json.loads(exc.value.read())
        assert "unknown field" in err["error"]
    # a typo'd knob must never have reached the engine as a silent default
    assert state.scheduler.metrics.snapshot().errors == 0


def test_all_documented_fields_still_accepted(serve_url):
    # the allowlist must not reject anything the API documents
    base, _ = serve_url
    status, d = _post(base + "/v1/generate", {
        "prompt": "đầy đủ " * 6, "max_new_tokens": 16, "temperature": 0.0,
        "top_k": 1, "top_p": 1.0, "seed": 3, "spec_k": 0,
        "deadline_ms": 30000, "request_id": "full-1",
        "reference": "tham khảo", "cache_hint": "đầy đủ",
    })
    assert status == 200 and d["completions"][0]["text"]
    status, d = _post(base + "/v1/summarize", {
        "text": DOC, "approach": "truncated", "max_new_tokens": 32,
        "deadline_ms": 60000, "request_id": "full-2",
    })
    assert status == 200 and d["summary"]


def test_single_chip_server_renders_no_mesh_gauges(serve_url):
    base, _ = serve_url
    _, body = _get(base + "/healthz")
    assert "mesh" not in json.loads(body)
    _, body = _get(base + "/metrics")
    assert "vnsum_serve_mesh_" not in body.decode()


# -- /readyz: routability, distinct from /healthz liveness -------------------


def _get_readyz(base):
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_readyz_ready_when_serving(serve_url):
    base, _ = serve_url
    status, body = _get_readyz(base)
    assert status == 200 and body["status"] == "ready"


def test_readyz_draining_is_typed_503(serve_url):
    """A draining server still answers /healthz (alive) but /readyz must
    say 503 draining — the router takes it out of rotation, not for dead."""
    base, state = serve_url
    state.scheduler.close()
    status, body = _get_readyz(base)
    assert status == 503
    assert body["error"] == "not_ready" and body["reason"] == "draining"
    # liveness stays answerable: the split IS the contract
    status, _ = _get(base + "/healthz")
    assert status == 200


def test_readyz_brownout_is_typed_503(serve_url):
    from types import SimpleNamespace

    from vnsum_tpu_torch.serve.supervisor import Rung

    base, state = serve_url
    saved = state.supervisor
    state.supervisor = SimpleNamespace(rung=Rung.BROWNOUT)
    try:
        status, body = _get_readyz(base)
        assert status == 503 and body["reason"] == "brownout"
        state.supervisor = SimpleNamespace(rung=Rung.NO_SPEC)
        status, body = _get_readyz(base)
        assert status == 200  # any rung short of brownout stays routable
    finally:
        state.supervisor = saved


@pytest.mark.parametrize("kw,item", [
    ({"journal_dir": "j"}, "A15b"),
    ({"tenants": object()}, "A15b"),
    ({"slo": "ttft_p99=0.5"}, "A15b"),
    ({"mesh": {"data": 2, "model": 2}}, "A10"),
])
def test_unported_serving_features_refuse_by_name(kw, item, tmp_path):
    """Durable serving, tenants, SLOs and the mesh are not ported yet:
    ServeState refuses each with its ROADMAP item, before any thread or
    file exists."""
    if "journal_dir" in kw:
        kw = {"journal_dir": str(tmp_path / "j")}
    with pytest.raises(NotImplementedError, match=item):
        ServeState(FakeBackend(), **kw)
    assert not (tmp_path / "j").exists()
