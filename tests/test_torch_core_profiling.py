"""The port's tracing and profiling (``vnsum_tpu_torch/core/profiling.py``)
against the JAX package's (``vnsum_tpu/core/profiling.py``).

The cases of ``tests/test_core_profiling.py`` on the port's ``Tracer``,
``device_profile`` and ``annotate``; the two Tracers fed the same spans
give the same aggregates; the tiny pipeline's ``results.tracing`` has the
JAX runner's span names and counts on the same run (fake backends, tiny
encoders); with ``VNSUM_PROFILE_DIR`` the runner writes the span timeline
and the device trace there; and the engine's ``annotate`` ranges show in a
``torch.profiler`` trace, one a group, segment or verify step.
"""
from __future__ import annotations

import functools
import json
import threading

import pytest
import torch

from vnsum_tpu.core.profiling import Tracer as JaxTracer
from vnsum_tpu_torch.core import Tracer as ExportedTracer
from vnsum_tpu_torch.core import annotate as exported_annotate
from vnsum_tpu_torch.core.profiling import SpanStats, Tracer, annotate, device_profile

from test_torch_models_llama import one_torch_thread  # noqa: F401


def test_span_aggregates():
    t = Tracer()
    for _ in range(3):
        with t.span("work"):
            pass
    stats = t.stats()
    assert stats["work"]["count"] == 3
    assert stats["work"]["total_s"] >= 0.0
    assert stats["work"]["min_s"] <= stats["work"]["max_s"]


def test_span_nesting_builds_hierarchical_names():
    t = Tracer()
    with t.span("outer"):
        with t.span("inner"):
            pass
    with t.span("inner"):
        pass
    assert set(t.stats()) == {"outer", "outer/inner", "inner"}


def test_span_exception_still_recorded():
    t = Tracer()
    with pytest.raises(ValueError):
        with t.span("boom"):
            raise ValueError
    assert t.stats()["boom"]["count"] == 1
    with t.span("after"):
        pass
    assert "boom/after" not in t.stats()


def test_tracer_thread_safety():
    t = Tracer()

    def worker():
        for _ in range(50):
            with t.span("shared"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.stats()["shared"]["count"] == 200


def test_record_external_duration():
    t = Tracer()
    t.record("device_step", 0.5)
    t.record("device_step", 1.5)
    s = t.stats()["device_step"]
    assert s["count"] == 2 and s["total_s"] == 2.0 and s["max_s"] == 1.5


def test_reset():
    t = Tracer()
    with t.span("x"):
        pass
    t.reset()
    assert t.stats() == {} and t.timeline() == []


def test_span_stats_empty_and_filled():
    s = SpanStats()
    assert s.to_dict() == {"count": 0, "total_s": 0.0, "mean_s": 0.0, "min_s": 0.0,
                           "max_s": 0.0}
    s.add(2.0)
    s.add(4.0)
    assert s.to_dict() == {"count": 2, "total_s": 6.0, "mean_s": 3.0, "min_s": 2.0,
                           "max_s": 4.0}


def test_exported_from_core():
    assert ExportedTracer is Tracer and exported_annotate is annotate


def test_the_two_tracers_aggregate_alike():
    """The same span sequence and recorded durations through both Tracers:
    the same names, counts and recorded totals; the same Chrome trace
    shape."""
    tracers = (Tracer(), JaxTracer())
    for t in tracers:
        with t.span("run"):
            for i in range(3):
                with t.span("batch"):
                    with t.span(f"leaf{i % 2}"):
                        pass
        t.record("device", 0.25)
        t.record("device", 0.75)
    port, jax = (t.stats() for t in tracers)
    assert sorted(port) == sorted(jax)
    assert {k: v["count"] for k, v in port.items()} == {k: v["count"] for k, v in jax.items()}
    assert port["device"] == jax["device"]
    pc, jc = (t.chrome_trace("pipeline") for t in tracers)
    assert sorted(pc) == sorted(jc)
    names = [sorted(e["name"] for e in tr["traceEvents"] if e["ph"] == "X") for tr in (pc, jc)]
    assert names[0] == names[1]


def test_device_profile_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("VNSUM_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_profile():
        pass
    assert list(tmp_path.iterdir()) == []


def test_device_profile_writes_trace(tmp_path):
    with device_profile(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("device_*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())["traceEvents"]


def test_annotate_is_usable():
    with annotate("phase"):
        pass


def test_annotate_is_a_range_in_a_torch_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("decode_seg[B=2,S=64]"):
            torch.ones(4) + 1
    assert sum(e.name == "decode_seg[B=2,S=64]" for e in prof.events()) == 1


# -- the pipeline runner ---------------------------------------------------------


def _docs(tmp_path, n=2):
    docs, refs = tmp_path / "doc", tmp_path / "summary"
    docs.mkdir()
    refs.mkdir()
    for i in range(n):
        (docs / f"d{i}.txt").write_text("một hai ba bốn năm " * 50)
        (refs / f"d{i}.txt").write_text("tóm tắt " * 5)
    return docs, refs


def _config(cls, tmp_path, approach, docs, refs, side):
    return cls(
        approach=approach, models=["fake"], backend="fake", docs_dir=str(docs),
        summary_dir=str(refs), generated_summaries_dir=str(tmp_path / side / "gen"),
        results_dir=str(tmp_path / side / "results"), logs_dir=str(tmp_path / side / "logs"),
    )


@pytest.fixture
def tiny_default_encoders(monkeypatch):
    """Both runners' default encoder a tiny one, so each run builds it (the
    embedder_init span) in well under a second."""
    import vnsum_tpu.eval as jax_eval
    import vnsum_tpu.models.encoder as je
    import vnsum_tpu_torch.models.encoder as te
    import vnsum_tpu_torch.pipeline.runner as port_runner
    from vnsum_tpu_torch.eval import EmbeddingModel

    monkeypatch.setattr(jax_eval, "EmbeddingModel", functools.partial(
        jax_eval.EmbeddingModel, config=je.tiny_encoder(), max_len=64))
    monkeypatch.setattr(port_runner, "EmbeddingModel", functools.partial(
        EmbeddingModel, config=te.tiny_encoder(), max_len=64, device="cpu"))


def _counts(tracing: dict) -> dict:
    return {k: v["count"] for k, v in tracing["spans"].items()}


@pytest.mark.parametrize("approach", ["truncated", "mapreduce"])
def test_pipeline_tracing_matches_the_jax_runner(tmp_path, tiny_default_encoders, approach):
    from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu.pipeline.runner import PipelineRunner as JaxRunner
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    docs, refs = _docs(tmp_path, n=3)
    jax = JaxRunner(_config(JaxPipelineConfig, tmp_path, approach, docs, refs, "jax")).run()
    port = PipelineRunner(_config(PipelineConfig, tmp_path, approach, docs, refs, "port"),
                          device="cpu").run()
    assert _counts(port.tracing) == _counts(jax.tracing)
    assert set(_counts(port.tracing)) == {
        "analyze", "summarize", "summarize/batch", "evaluate", "evaluate/embedder_init",
        "evaluate/embed", "evaluate/bertscore", "evaluate/rouge"}
    assert _counts(port.tracing)["evaluate/rouge"] == 3
    d = port.to_dict()
    assert d["results"]["tracing"] == port.tracing
    assert list(d["results"]) == ["document_stats", "summarization", "evaluation", "tracing",
                                  "engine"]
    saved = json.loads(
        next((tmp_path / "port" / "results").glob("pipeline_results_*.json")).read_text())
    assert _counts(saved["results"]["tracing"]) == _counts(jax.tracing)


def test_pipeline_records_tracing(tmp_path):
    """The JAX file's runner case on the port, with an injected encoder (no
    embedder_init span, as in the JAX case)."""
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.eval import EmbeddingModel
    from vnsum_tpu_torch.models.encoder import tiny_encoder
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    docs, refs = _docs(tmp_path)
    runner = PipelineRunner(
        _config(PipelineConfig, tmp_path, "truncated", docs, refs, "port"), device="cpu",
        embedding_model=EmbeddingModel(config=tiny_encoder(), max_len=64, batch_size=4,
                                       device="cpu"),
    )
    results = runner.run()
    spans = results.tracing["spans"]
    assert {"analyze", "summarize", "summarize/batch", "evaluate"} <= set(spans)
    assert "evaluate/embedder_init" not in spans
    assert results.to_dict()["results"]["tracing"]["spans"]["summarize"]["count"] == 1


def test_profile_dir_gets_the_span_timeline_and_a_device_trace(tmp_path, monkeypatch,
                                                                 tiny_default_encoders):
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    prof = tmp_path / "prof"
    monkeypatch.setenv("VNSUM_PROFILE_DIR", str(prof))
    docs, refs = _docs(tmp_path)
    PipelineRunner(_config(PipelineConfig, tmp_path, "truncated", docs, refs, "port"),
                   device="cpu").run()
    timelines = list(prof.glob("pipeline_*.json"))
    assert len(timelines) == 1
    events = json.loads(timelines[0].read_text())["traceEvents"]
    assert {"analyze", "summarize", "summarize/batch", "evaluate"} <= {
        e["name"] for e in events if e["ph"] == "X"}
    # the first document group ran under device_profile
    assert len(list(prof.glob("device_*.json"))) == 1


# -- the engine's ranges ---------------------------------------------------------


def _ranges(fn) -> dict:
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = Counter(e.name for e in prof.events())
    return {k: v for k, v in names.items()
            if k.startswith(("generate[", "prefill[", "decode_seg[", "spec_", "choice["))}


@pytest.fixture(scope="module")
def tiny_engine():
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.core.config import GenerationConfig
    from vnsum_tpu_torch.models.llama import init_model, tiny_llama

    model = init_model(tiny_llama(max_seq_len=128), 0, "cpu")
    return lambda **kw: TorchBackend(model=model, flash=True, device="cpu", batch_size=2,
                                     max_new_tokens=24, generation=GenerationConfig(**kw))


def test_engine_ranges_one_a_group(tiny_engine):
    b = tiny_engine()
    prompts = ["văn bản một", "hai", "ba bốn năm sáu", "bảy"]  # two groups of 2
    got = _ranges(lambda: b.generate(prompts))
    assert got == {"generate[B=2,S=64]": 2, "prefill[B=2,S=64]": 2, "decode_seg[B=2,S=64]": 2}


def test_engine_ranges_spec_and_choice(tiny_engine):
    b = tiny_engine(spec_k=4)
    got = _ranges(lambda: b.generate(["văn bản một về kinh tế", "hai"],
                                     references=["văn bản một về kinh tế xã hội", "hai ba"]))
    steps = b.stats.spec_verify_steps
    assert steps > 0
    assert got == {"spec_prefill[B=2,S=64]": 1, "spec_step[B=2,S=64,k=4]": steps}
    got = _ranges(lambda: b.score_choices(["một", "hai"], ["1", "2"]))
    assert got == {"choice[B=2,S=64]": 1}
