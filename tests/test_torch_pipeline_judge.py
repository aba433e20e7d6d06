"""The port's runner and CLI with the G-Eval judge and the backend choice,
against the JAX package's: ``--backend fake --judge-backend fake`` over
data/vi_eval writes the same summaries and the same ``llm_scores`` block;
``_default_backend_factory``, ``_judge_backend`` and ``_build_llm_judge``
resolve and refuse as JAX's do, with ``torch`` for ``tpu``; EvalConfig and
the config's validation equal JAX's.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import re
from pathlib import Path

import pytest

import vnsum_tpu.eval as jax_eval
from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.backend.ollama import OllamaBackend as JaxOllamaBackend
from vnsum_tpu.core.config import EvalConfig as JaxEvalConfig
from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.models import encoder as je
from vnsum_tpu.pipeline import cli as jax_cli
from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
from vnsum_tpu_torch.backend import FakeBackend, OllamaBackend, TorchBackend
from vnsum_tpu_torch.core.config import EvalConfig, PipelineConfig
from vnsum_tpu_torch.eval import LLMJudge
from vnsum_tpu_torch.models import MODEL_REGISTRY
from vnsum_tpu_torch.pipeline import cli
from vnsum_tpu_torch.pipeline.runner import PipelineRunner

from test_torch_eval_embedding import small_default_encoder
from test_torch_models_llama import one_torch_thread  # noqa: F401
from torch_strategy_parity import FIXTURE, dirs

DOC_NAMES = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))


@pytest.fixture()
def warnings_logged():
    """The messages logged under the "vnsum" logger (both packages') while
    the test runs."""
    messages = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("vnsum").addHandler(handler)
    yield messages
    logging.getLogger("vnsum").removeHandler(handler)


def test_eval_config_fields_and_defaults_equal_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(EvalConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JaxEvalConfig)]
    assert got == want
    assert dataclasses.asdict(EvalConfig()) == dataclasses.asdict(JaxEvalConfig())


def test_backend_fields_and_defaults():
    """``backend`` and ``ollama_url`` are JAX's fields; the default backend is
    the port's engine where JAX's is its own."""
    assert PipelineConfig().backend == "torch" and JaxPipelineConfig().backend == "tpu"
    assert PipelineConfig().ollama_url == JaxPipelineConfig().ollama_url
    args = cli.build_parser().parse_args([])
    assert args.backend == "torch" and args.ollama_url == "http://localhost:11434"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--backend", "tpu"])
    for backend in ("fake", "ollama"):
        argv = ["--backend", backend, "--ollama-url", "http://h:2"]
        got = cli.config_from_args(cli.build_parser().parse_args(argv))
        want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
        assert (got.backend, got.ollama_url) == (want.backend, want.ollama_url)


@pytest.mark.parametrize("kw", [
    {"weights_dir": "ckpt", "backend": "fake"},
    {"weights_dir": "ckpt", "backend": "ollama"},
    {"quantize": True, "backend": "ollama"},
    {"quantize": True, "quantize_act": True, "backend": "fake"},
    {"quantize_act": True},
], ids=["weights_fake", "weights_ollama", "quantize_ollama", "quantize_fake", "act_alone"])
def test_validation_errors_match_jax(kw):
    with pytest.raises(ValueError) as got:
        PipelineConfig(**kw)
    with pytest.raises(ValueError) as want:
        JaxPipelineConfig(**kw)
    assert str(got.value) == str(want.value).replace("'tpu'", "'torch'")
    # the port's own backend passes where JAX's does
    PipelineConfig(**{**kw, "backend": "torch", "quantize": True})


def runners(tmp_path, **kw):
    port = PipelineRunner(PipelineConfig(**dirs(tmp_path / "port"), **kw), device="cpu")
    jax = JaxPipelineRunner(JaxPipelineConfig(**dirs(tmp_path / "jax"), **kw))
    return port, jax


def test_default_backend_factory_follows_the_config(tmp_path):
    port, jax = runners(tmp_path, backend="ollama", ollama_url="http://h:3/",
                        max_new_tokens=77)
    got, want = port._default_backend_factory("qwen3:8b"), jax._default_backend_factory("qwen3:8b")
    assert isinstance(got, OllamaBackend) and isinstance(want, JaxOllamaBackend)
    assert vars(got) == vars(want)
    port, jax = runners(tmp_path, backend="fake")
    assert isinstance(port._default_backend_factory("x"), FakeBackend)
    assert isinstance(jax._default_backend_factory("x"), JaxFakeBackend)
    port, _ = runners(tmp_path, backend="torch", models=["tiny"], max_new_tokens=8)
    tb = port._default_backend_factory("tiny")
    assert isinstance(tb, TorchBackend) and tb.device.type == "cpu"
    port.config.backend = "nope"
    with pytest.raises(ValueError, match="unknown backend 'nope'"):
        port._default_backend_factory("tiny")


def test_judge_backend_resolves_as_jax(tmp_path, warnings_logged):
    port, jax = runners(tmp_path, ollama_url="http://h:4")
    assert isinstance(port._judge_backend("fake"), FakeBackend)
    got, want = port._judge_backend("ollama:qwen3:8b"), jax._judge_backend("ollama:qwen3:8b")
    assert vars(got) == vars(want) and got.model == "qwen3:8b" and got.url == "http://h:4"
    tb = port._judge_backend("torch:tiny")
    jb = jax._judge_backend("tpu:tiny")
    assert isinstance(tb, TorchBackend) and isinstance(jb, TpuBackend)
    assert tb.max_new_tokens == jb.max_new_tokens == 64 and tb.device.type == "cpu"
    assert tb.cfg.n_layers == jb.cfg.n_layers and tb.cfg.dim == jb.cfg.dim
    assert [m.split(" runs ")[0] for m in warnings_logged] == ["torch judge 'tiny'",
                                                               "tpu judge 'tiny'"]


@pytest.mark.parametrize("spec,jax_spec", [
    ("nope", "nope"), ("ollama", "ollama"), ("ollama:", "ollama:"), ("torch:nope", "tpu:nope"),
    ("torch", "tpu"), ("tpu:tiny", "torch:tiny"),
])
def test_judge_backend_errors_match_jax(tmp_path, spec, jax_spec):
    port, jax = runners(tmp_path)
    with pytest.raises(ValueError) as got:
        port._judge_backend(spec)
    with pytest.raises(ValueError) as want:
        jax._judge_backend(jax_spec)
    # the two registries list different models (the port's holds those it
    # runs): the message is compared up to the list
    expect = str(want.value).replace("tpu", "torch").replace(
        "unknown judge_backend spec 'torch:tiny'", "unknown judge_backend spec 'tpu:tiny'")
    assert re.sub(r"\(have \[.*?\]\)", "(have [...])", str(got.value)) == re.sub(
        r"\(have \[.*?\]\)", "(have [...])", expect)
    if "registry model" in expect:
        assert f"(have {sorted(MODEL_REGISTRY)})" in str(got.value)


def test_build_llm_judge_order_matches_jax(tmp_path, monkeypatch, warnings_logged):
    for key in ("OPENROUTER_API_KEY", "OPENAI_API_KEY"):
        monkeypatch.delenv(key, raising=False)
    port, jax = runners(tmp_path)
    assert port._build_llm_judge() is None and jax._build_llm_judge() is None
    assert sum("skipping G-Eval" in m for m in warnings_logged) == 2
    monkeypatch.setenv("OPENAI_API_KEY", "sk-x")
    for use_openrouter in (True, False):
        port.config.evaluation.use_openrouter = jax.config.evaluation.use_openrouter = use_openrouter
        got, want = port._build_llm_judge(), jax._build_llm_judge()
        assert (got.api_base, got.api_key, got.model, got.backend) == (
            want.api_base, want.api_key, want.model, want.backend)
    port.config.evaluation.judge_backend = jax.config.evaluation.judge_backend = "fake"
    assert isinstance(port._build_llm_judge().backend, FakeBackend)
    assert isinstance(jax._build_llm_judge().backend, JaxFakeBackend)
    injected = LLMJudge(backend=FakeBackend())
    assert PipelineRunner(port.config, llm_judge=injected, device="cpu")._build_llm_judge() is injected


def test_injected_judge_reaches_the_results(tmp_path, monkeypatch):
    """PipelineRunner(llm_judge=...) with include_llm_eval: the judge scores
    every file of the run, its block in the model's evaluation."""
    small_default_encoder(monkeypatch)
    cfg = PipelineConfig(approach="mapreduce", models=["fake"], backend="fake",
                         chunk_size=400, chunk_overlap=40, max_samples=3, **dirs(tmp_path))
    cfg.evaluation.include_llm_eval = True
    judge = LLMJudge(backend=FakeBackend(responses=['{"score": 5}', "3"] * 3))
    runner = PipelineRunner(cfg, llm_judge=judge, device="cpu")
    res = runner.run()
    assert runner.failures == []
    scores = res.evaluation["fake"]["llm_scores"]
    assert scores["llm_successful_cases"] == 3 and scores["llm_correctness_mean"] == 1.0
    assert scores["llm_coherence_mean"] == 0.5
    # without include_llm_eval the injected judge is not asked
    cfg.evaluation.include_llm_eval = False
    res = PipelineRunner(cfg, llm_judge=LLMJudge(backend=FakeBackend(responses=["1"])),
                         device="cpu").run()
    assert "llm_scores" not in res.evaluation["fake"]


def test_cli_fake_backend_and_fake_judge_match_jax(tmp_path, monkeypatch):
    """The port's CLI and the JAX CLI with ``--backend fake --judge-backend
    fake`` over data/vi_eval: byte-identical summaries, equal ROUGE and an
    equal ``llm_scores`` block (the embedding metrics run on each package's
    own random encoder and are not compared)."""
    small_default_encoder(monkeypatch)
    monkeypatch.setattr(jax_eval, "EmbeddingModel", functools.partial(
        jax_eval.EmbeddingModel, config=je.tiny_encoder(), max_len=64))
    monkeypatch.chdir(tmp_path)  # the JAX CLI logs into ./logs
    flags = ["--approach", "mapreduce", "--models", "fake", "--backend", "fake",
             "--judge-backend", "fake", "--chunk-size", "400"]
    results = {}
    for name, mod in (("port", cli), ("jax", jax_cli)):
        argv = list(flags)
        for k, v in dirs(tmp_path / name).items():
            if name == "port" or k != "logs_dir":
                argv += ["--" + k.replace("_", "-"), v]
        assert mod.main(argv + (["--device", "cpu"] if name == "port" else [])) == 0
        saved = json.loads(next((tmp_path / name / "results").glob(
            "pipeline_results_*.json")).read_text())
        gen = tmp_path / name / "gen_mapreduce_fake"
        results[name] = (saved, {p.name: p.read_bytes() for p in sorted(gen.glob("*.txt"))})
    (port, port_gen), (jax, jax_gen) = results["port"], results["jax"]
    assert sorted(port_gen) == DOC_NAMES and port_gen == jax_gen
    assert port["config"]["evaluation"]["judge_backend"] == "fake"
    assert port["config"]["evaluation"]["include_llm_eval"] is True
    got, want = port["results"]["evaluation"]["fake"], jax["results"]["evaluation"]["fake"]
    assert got["rouge_scores"] == want["rouge_scores"]
    assert got["llm_scores"] == want["llm_scores"]
    assert got["llm_scores"]["llm_total_cases_processed"] == len(DOC_NAMES)
    assert port["results"]["summarization"]["fake"]["successful"] == len(DOC_NAMES)
