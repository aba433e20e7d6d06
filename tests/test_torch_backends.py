"""The port's backend registry (``backend.base.get_backend``), its
``FakeBackend`` and its ``OllamaBackend`` against the JAX package's.

The fakes run every strategy of both packages over the documents of
data/vi_eval, extractive and scripted, and must return the same strings
and record the same calls, batch sizes and references. The Ollama
backends run against a stub ``requests`` module, as
tests/test_backend_ollama.py does, and must send the same requests and
retry, time out and check health alike.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

from vnsum_tpu.backend import base as jax_base
from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.backend.ollama import OllamaBackend as JaxOllamaBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.strategies import get_strategy as jax_get_strategy
from vnsum_tpu_torch.backend import FakeBackend, OllamaBackend, TorchBackend, get_backend
from vnsum_tpu_torch.core.config import APPROACHES, GenerationConfig, PipelineConfig
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.strategies import get_strategy

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
DOCS = [p.read_text(encoding="utf-8") for p in sorted((FIXTURE / "doc").glob("*.txt"))]
# small chunks, so map-reduce and its kin take several chunks and rounds
KNOBS = dict(chunk_size=300, chunk_overlap=30, token_max=200, iterative_chunk_size=300,
             iterative_chunk_overlap=30, max_context=600, max_new_tokens=64)


def run_strategy(approach: str, backend, get, config_cls):
    strategy = get(approach, backend, config_cls(approach=approach, **KNOBS))
    return [(r.summary, r.num_chunks, r.llm_calls) for r in strategy.summarize_batch(DOCS)]


@pytest.mark.parametrize("mode", ["extractive", "scripted"])
@pytest.mark.parametrize("approach", APPROACHES)
def test_fake_backend_runs_every_strategy_as_jax(approach, mode):
    """Both fakes under both packages' strategies over data/vi_eval: the
    same summaries and every prompt, batch and reference alike. The scripted
    fake answers with numbered responses, so every call's answers differ."""
    kw = {} if mode == "extractive" else {
        "responses": [f"Bản tóm tắt số {i}. Điểm chính {i % 7}." for i in range(400)]}
    port, jax = FakeBackend(summary_words=12, **kw), JaxFakeBackend(summary_words=12, **kw)
    got = run_strategy(approach, port, get_strategy, PipelineConfig)
    want = run_strategy(approach, jax, jax_get_strategy, JaxPipelineConfig)
    assert got == want
    assert port.calls == jax.calls and len(port.calls) >= len(DOCS)
    assert port.batch_sizes == jax.batch_sizes
    assert port.references_seen == jax.references_seen
    assert port.cache_hints_seen == jax.cache_hints_seen


@pytest.mark.parametrize("spec_k,from_config", [(4, True), (3, False), (0, True)])
def test_fake_spec_reports_match_jax(spec_k, from_config):
    prompts = ["<content>\nmột hai ba bốn năm sáu\n</content>", "không có khối", "x y"]
    refs = ["một hai ba", None, "tham chiếu"]
    reports = []
    for cls, gen_cls in ((FakeBackend, GenerationConfig), (JaxFakeBackend, JaxGenerationConfig)):
        be = cls(spec_acceptance=0.5, spec_k=0 if from_config else spec_k)
        config = gen_cls(spec_k=spec_k) if from_config else None
        outs = be.generate(prompts, config=config, references=refs)
        reports.append((outs, [r.to_dict() for r in be.take_spec_report()],
                        be.take_spec_report(), be.references_seen))
    assert reports[0] == reports[1]
    assert len(reports[0][1]) == (3 if spec_k else 0)


def test_fake_latency_model(monkeypatch):
    """One sleep a call: batch_overhead_s + per_token_s per prompt word and
    per_prompt_s a row (rows divided over dp_replicas, rounded up), plus
    per_step_s for the longest row's output words, as JAX's reckons it.
    The sleep is the cancellable one (``_sleep_cancellable``, sliced so a
    cancel poll or a drain cuts it short)."""
    slept = []
    monkeypatch.setattr(FakeBackend, "_sleep_cancellable", lambda self, s: slept.append(s))
    be = FakeBackend(summary_words=3, batch_overhead_s=0.5, per_token_s=0.01,
                     per_prompt_s=0.1, per_step_s=0.02, dp_replicas=2)
    outs = be.generate(["a b c d e", "f g", "h"])
    words = 5 + 2 + 1
    want = 0.5 + 0.01 * -(-words // 2) + 0.1 * -(-3 // 2) + 0.02 * max(
        len(o.split()) for o in outs)
    assert slept == [pytest.approx(want)]
    assert be.batch_sizes == [3]
    slept.clear()
    FakeBackend().generate(["a"])
    assert slept == []


def test_fake_refuses_what_is_not_ported(capsys):
    # the prefix-cache mirror is ported: the radix index over words
    cached = FakeBackend(prefix_cache_blocks=16)
    prompts = ["mot tieu de chung dai hon tam tu " * 2 + f"so {i}" for i in range(2)]
    cached.generate(prompts)
    cached.generate(prompts)
    assert cached.take_cache_report() == [16, 16]
    assert cached.prefix_cache_stats()["blocks_total"] == 16
    be = FakeBackend()
    # the serving hooks are ported (FakeSlotLoop, cancel and drain); what
    # stays unported refuses by its ROADMAP item
    loop = be.start_slot_loop(2)
    assert loop.admit([("k", "mot hai ba", None)])[0][0].slot == 0
    be.set_cancel_poll(None)
    be.request_drain()
    be.reset_drain()
    with pytest.raises(NotImplementedError, match="A5c"):
        get_backend("hf")
    from vnsum_tpu_torch.serve.server import ServeState, main

    # durable serving and tenants are ported (a tenant table arms the
    # queue's pick); the serving mesh is not
    from vnsum_tpu_torch.serve.qos import TenantTable, parse_tenant_specs

    state = ServeState(be, tenants=TenantTable(parse_tenant_specs("ui:2:0")))
    try:
        assert state.scheduler.queue.tenants is state.tenants
    finally:
        state.close()
    with pytest.raises(NotImplementedError, match="A10"):
        ServeState(be, mesh={"data": 2})
    with pytest.raises(SystemExit):
        main(["--backend", "fake", "--mesh", "data=2"])
    assert "--mesh: multi-card serving is ROADMAP A10" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="ran out of scripted responses"):
        FakeBackend(responses=["one"]).generate(["a", "b"])
    assert be.count_tokens("xin chào  bạn") == 3 == JaxFakeBackend().count_tokens("xin chào  bạn")
    assert be.count_tokens_batch(["a b", ""]) == [2, 0]


def test_get_backend_registry_and_refusals():
    assert isinstance(get_backend("fake", summary_words=3), FakeBackend)
    assert isinstance(get_backend("ollama", model="m"), OllamaBackend)
    tb = get_backend("torch", model_config=tl.tiny_llama(), max_new_tokens=8, device="cpu")
    assert isinstance(tb, TorchBackend) and tb.max_new_tokens == 8
    with pytest.raises(NotImplementedError, match="hf backend .* not ported yet"):
        get_backend("hf")
    for spec in ("tpu", "nope", ""):
        with pytest.raises(ValueError) as got:
            get_backend(spec)
        assert str(got.value) == f"unknown backend {spec!r} (use torch|ollama|fake)"
    with pytest.raises(ValueError) as want:
        jax_base.get_backend("nope")
    assert str(want.value) == "unknown backend 'nope' (use tpu|ollama|hf|fake)"
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            get_backend("torch", model_config=tl.tiny_llama())


# -- OllamaBackend against a stub requests, as tests/test_backend_ollama.py ---


class Response:
    def __init__(self, payload=None, status=200):
        self._payload = payload or {}
        self.status_code = status
        self._requests = None

    def raise_for_status(self):
        if self.status_code >= 400:
            raise self._requests.HTTPError(response=self)

    def json(self):
        return self._payload


@pytest.fixture()
def fake_requests(monkeypatch):
    mod = types.ModuleType("requests")

    class ConnectionError(Exception):
        pass

    class Timeout(Exception):
        pass

    class HTTPError(Exception):
        def __init__(self, response=None):
            self.response = response

    mod.ConnectionError, mod.Timeout, mod.HTTPError = ConnectionError, Timeout, HTTPError
    mod.calls, mod.responses = [], []

    def answer(item):
        if isinstance(item, Exception):
            raise item
        item._requests = mod
        return item

    def post(url, json=None, timeout=None):
        mod.calls.append({"url": url, "json": json, "timeout": timeout})
        return answer(mod.responses.pop(0))

    def get(url, timeout=None):
        mod.calls.append({"url": url, "json": None, "timeout": timeout})
        return answer(mod.responses.pop(0))

    mod.post, mod.get = post, get
    monkeypatch.setitem(sys.modules, "requests", mod)
    return mod


def scenario(name: str, req):
    """(constructor keywords, responses, call) of one scenario; call(be,
    gen_cls) returns what the backend gives back."""
    ok = lambda text: Response({"response": text})  # noqa: E731
    if name == "payload":
        return (dict(model="llama3.2:3b", url="http://h:1/"),
                [ok("<think>x</think>KQ")],
                lambda be, g: be.generate(["xin chào"], max_new_tokens=77))
    if name == "options":
        return ({}, [ok("ok")], lambda be, g: be.generate(
            ["p"], config=g(temperature=0.7, top_k=40, top_p=0.9, seed=11)))
    if name == "greedy_config":
        return (dict(clean_output=False), [ok("<think>t</think>raw")],
                lambda be, g: be.generate(["p"], config=g(max_new_tokens=9)))
    if name == "retry_transient":
        return (dict(max_retries=3, retry_backoff=0),
                [req.ConnectionError("down"), Response(status=503), Response({}), ok("ok")],
                lambda be, g: be.generate(["p"]))
    if name == "timeout_not_retried":
        return (dict(max_retries=3, retry_backoff=0), [req.Timeout("hung")],
                lambda be, g: be.generate(["p"]))
    if name == "client_error_not_retried":
        return (dict(max_retries=2, retry_backoff=0), [Response(status=404)],
                lambda be, g: be.generate(["p"]))
    if name == "retries_exhausted":
        return (dict(max_retries=2, retry_backoff=0), [req.ConnectionError("down")] * 3,
                lambda be, g: be.generate(["p"]))
    if name == "batch":
        return (dict(concurrency=1, max_new_tokens=5), [ok("a"), ok("b"), ok("c")],
                lambda be, g: be.generate(["p1", "p2", "p3"]))
    if name == "health_check":
        return (dict(connect_timeout=3.5), [Response(
            {"models": [{"name": "llama3.2:3b"}, {"name": "qwen3:8b"}]})],
            lambda be, g: be.health_check())
    raise KeyError(name)


SCENARIOS = ["payload", "options", "greedy_config", "retry_transient", "timeout_not_retried",
             "client_error_not_retried", "retries_exhausted", "batch", "health_check"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_ollama_backend_matches_jax(fake_requests, monkeypatch, name):
    delays = []
    monkeypatch.setattr("time.sleep", delays.append)
    seen = []
    for cls, gen_cls in ((OllamaBackend, GenerationConfig), (JaxOllamaBackend, JaxGenerationConfig)):
        kw, responses, call = scenario(name, fake_requests)
        fake_requests.calls, fake_requests.responses = [], list(responses)
        delays.clear()
        try:
            out = call(cls(**kw), gen_cls)
        except Exception as e:  # noqa: BLE001 - the failure is what is compared
            out = (type(e).__name__, str(e))
        seen.append((out, fake_requests.calls, list(delays)))
    assert seen[0] == seen[1]
    if name == "payload":
        body = seen[0][1][0]["json"]
        assert seen[0][0] == ["KQ"] and seen[0][1][0]["url"] == "http://h:1/api/generate"
        assert body == {"model": "llama3.2:3b", "prompt": "xin chào", "stream": False,
                        "think": False, "options": {"num_predict": 77}}
        assert seen[0][1][0]["timeout"] == (5.0, 600.0)
    if name == "retry_transient":
        assert seen[0][0] == ["ok"] and len(seen[0][1]) == 4
    if name == "health_check":
        assert seen[0][0] == ["llama3.2:3b", "qwen3:8b"] and seen[0][1][0]["timeout"] == (3.5, 10)


def test_ollama_retry_backoff_is_jittered_and_bounded(fake_requests, monkeypatch):
    delays = []
    monkeypatch.setattr("time.sleep", delays.append)
    fake_requests.responses = [fake_requests.ConnectionError("down")] * 2 + [
        Response({"response": "ok"})]
    be = OllamaBackend(max_retries=3, retry_backoff=1.0, retry_jitter=0.5)
    assert be.generate(["p"]) == ["ok"]
    assert len(delays) == 2 and 1.0 <= delays[0] <= 1.5 and 2.0 <= delays[1] <= 3.0
    assert be.max_retries == 3 and OllamaBackend(max_retries=-1).max_retries == 0
    assert be.count_tokens_batch(["a b", "c"]) == [2, 1]
