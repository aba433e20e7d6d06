"""The strategies' streaming rounds (``submit_round``/``harvest`` over the
serving layer's QueuedBackend): mapreduce, hierarchical and skeleton on
seeded multi-chunk documents. Over the fake backends the port's streaming
summaries equal, byte for byte, the JAX package's streaming summaries over
its own serving layer and the port's barrier route; the journal's GANG
records carry the phases only the streaming route labels. A POISON-failed
member is dropped from its reduce (``dropped_chunks`` / ``dropped_points``)
and the gang is marked ``partial`` in both packages alike. One tiny f32
Llama case holds the port's streaming map-reduce through
``TorchBackend(device="cpu")`` to the JAX engine's barrier output."""
from __future__ import annotations

import re

import numpy as np
import pytest

from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.serve import EngineSupervisor as JaxEngineSupervisor
from vnsum_tpu.serve import MicroBatchScheduler as JaxMicroBatchScheduler
from vnsum_tpu.serve import RetryPolicy as JaxRetryPolicy
from vnsum_tpu.serve.journal import RequestJournal as JaxRequestJournal
from vnsum_tpu.serve.scheduler import QueuedBackend as JaxQueuedBackend
from vnsum_tpu.strategies import get_strategy as jax_get_strategy
from vnsum_tpu.testing.faults import FaultPlan as JaxFaultPlan
from vnsum_tpu.testing.faults import FaultSpec as JaxFaultSpec
from vnsum_tpu.testing.faults import injected as jax_injected
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.core.config import PipelineConfig
from vnsum_tpu_torch.serve import EngineSupervisor, MicroBatchScheduler, RetryPolicy
from vnsum_tpu_torch.serve.journal import RequestJournal
from vnsum_tpu_torch.serve.scheduler import QueuedBackend
from vnsum_tpu_torch.strategies import get_strategy
from vnsum_tpu_torch.testing.faults import FaultPlan, FaultSpec, injected

from test_torch_models_llama import one_torch_thread  # noqa: F401

_SYLLABLES = ("văn bản tóm tắt nội dung chính của tài liệu dài được chia thành "
              "nhiều phần nhỏ để mô hình đọc từng đoạn rồi tổng hợp lại thành "
              "một bản ngắn gọn đầy đủ ý nghĩa sông núi biển trời người dân "
              "kinh tế văn hóa lịch sử giáo dục khoa học công nghệ").split()
# the poison marker of the map cases: a chunk holding it fails typed POISON
MARK = "HỎNG-ĐOẠN"
# the skeleton outline's synthetic third point: its expansion prompt, and
# no outline prompt, holds this marker
POINT_MARK = "ĐIỂM-HỎNG"


def make_docs(seed: int, n_docs: int, poison: bool = False) -> list[str]:
    """``n_docs`` documents of seeded Vietnamese-like paragraphs, each long
    enough to split into several chunks at CHUNK whitespace tokens; with
    ``poison``, one paragraph of the first document opens with MARK."""
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n_docs):
        paras = []
        for p in range(int(rng.integers(5, 8))):
            words = [_SYLLABLES[i] for i in rng.integers(0, len(_SYLLABLES),
                                                        int(rng.integers(40, 70)))]
            if poison and d == 0 and p == 2:
                words[0] = MARK
            paras.append(f"Đoạn {d}.{p}: " + " ".join(words) + ".")
        docs.append("\n\n".join(paras))
    return docs


def outline_one(prompt: str) -> str | None:
    """A numbered outline for a skeleton outline prompt (three points from
    the document's first words, the third carrying POINT_MARK), None for
    any other prompt: the fakes then answer extractively."""
    if "Dàn ý:" not in prompt or not prompt.rstrip().endswith("Dàn ý:"):
        return None
    words = re.findall(r"\w+", prompt.split("Tài liệu:")[-1])
    return "\n".join([f"1. {' '.join(words[0:4])}", f"2. {' '.join(words[4:8])}",
                      f"3. {POINT_MARK} {' '.join(words[8:12])}"])


class OutlineFake(FakeBackend):
    def _one(self, prompt: str) -> str:
        return outline_one(prompt) or super()._one(prompt)


class JaxOutlineFake(JaxFakeBackend):
    def _one(self, prompt: str) -> str:
        return outline_one(prompt) or super()._one(prompt)


CHUNK = 120
KNOBS = {
    "mapreduce": dict(chunk_size=CHUNK, chunk_overlap=10, token_max=100),
    "mapreduce_hierarchical": dict(chunk_size=CHUNK, chunk_overlap=10),
    "skeleton": dict(max_context=4096),
}
# what the streaming route labels each round, as the gang's journal holds it
PHASES = {"mapreduce": {"map", "reduce"}, "mapreduce_hierarchical": {"map", "reduce", ""},
          "skeleton": {"outline", "expand"}}

PORT = dict(fake=OutlineFake, cfg=PipelineConfig, get_strategy=get_strategy,
            sched=MicroBatchScheduler, queued=QueuedBackend, journal=RequestJournal,
            supervisor=EngineSupervisor, retry=RetryPolicy, plan=FaultPlan,
            spec=FaultSpec, injected=injected)
JAX = dict(fake=JaxOutlineFake, cfg=JaxPipelineConfig, get_strategy=jax_get_strategy,
           sched=JaxMicroBatchScheduler, queued=JaxQueuedBackend, journal=JaxRequestJournal,
           supervisor=JaxEngineSupervisor, retry=JaxRetryPolicy, plan=JaxFaultPlan,
           spec=JaxFaultSpec, injected=jax_injected)


def _cfg(pkg, approach):
    return pkg["cfg"](approach=approach, models=["fake"], max_new_tokens=16,
                      **KNOBS[approach])


def _view(results) -> list:
    return [(r.summary, r.num_chunks, r.llm_calls, r.rounds, dict(r.meta)) for r in results]


def streaming(pkg, approach, docs, tmp_path, poison: str | None = None):
    """One strategy run over ``pkg``'s QueuedBackend under a gang, journaled
    (so the GANG records show the rounds' phases). Returns (results,
    submit_round phases in call order, the gang's journal info, whether the
    gang was marked partial, the views' barrier generate calls)."""
    backend = pkg["fake"]()
    journal = pkg["journal"](tmp_path)
    supervisor = pkg["supervisor"](pkg["retry"](max_attempts=2, backoff_base_s=0.001,
                                                backoff_max_s=0.01, jitter=0.0))
    sched = pkg["sched"](backend, max_batch=8, max_wait_s=0.002, journal=journal,
                         supervisor=supervisor)
    try:
        handle = sched.admit_gang("g")
        view = pkg["queued"](sched, trace_id="g", gang="g")
        phases, barrier = [], []
        submit_round, generate = view.submit_round, view.generate

        def spy_submit(prompts, *, phase="map", **kw):
            phases.append(phase)
            return submit_round(prompts, phase=phase, **kw)

        def spy_generate(prompts, **kw):
            barrier.append(len(prompts))
            return generate(prompts, **kw)

        view.submit_round, view.generate = spy_submit, spy_generate
        strategy = pkg["get_strategy"](approach, backend, _cfg(pkg, approach))
        if poison:
            plan = pkg["plan"]([pkg["spec"](site="fake.dispatch", kind="poison",
                                            match=poison)])
            with pkg["injected"](plan):
                results = strategy.summarize_batch(docs, backend=view)
        else:
            results = strategy.summarize_batch(docs, backend=view)
        partial = sched.gangs.lookup("g")["partial"]
        handle.finish()
        info = journal.gang_info("g")
    finally:
        sched.close()
        journal.close()
    return results, phases, info, partial, barrier


def barrier(approach, docs):
    backend = OutlineFake()
    strategy = get_strategy(approach, backend, _cfg(PORT, approach))
    return strategy.summarize_batch(docs)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("approach", sorted(KNOBS))
def test_streaming_equals_jax_streaming_and_the_barrier_route(approach, seed, tmp_path):
    docs = make_docs(seed, n_docs=2 + seed % 2)
    port, phases, info, partial, calls = streaming(PORT, approach, docs, tmp_path / "p")
    jax, jax_phases, jax_info, jax_partial, _ = streaming(JAX, approach, docs, tmp_path / "j")
    plain = barrier(approach, docs)
    # multi-chunk documents (skeleton: three points each), and text out
    assert all(r.num_chunks >= 3 for r in port) and all(r.summary for r in port)
    assert _view(port) == _view(jax)
    assert [r.summary for r in port] == [r.summary for r in plain]
    assert _view(port) == _view(plain)
    # the streaming route ran: rounds submitted by phase, joined per
    # document; only hierarchical's polish is a barrier round
    assert phases == jax_phases and phases[0] == ("outline" if approach == "skeleton" else "map")
    assert calls == ([len(docs)] if approach == "mapreduce_hierarchical" else [])
    assert info == jax_info and set(info["members"].values()) == PHASES[approach]
    assert not partial and not jax_partial and not info["partial"]
    if approach == "mapreduce":
        # token_max forces collapse rounds, each submitted from harvest
        assert all(r.rounds >= 1 for r in port)
        assert phases.count("reduce") > len(docs)


@pytest.mark.parametrize("approach", sorted(KNOBS))
def test_poison_member_dropped_and_gang_partial(approach, tmp_path):
    """A member failing typed POISON (a map chunk; a skeleton expansion) is
    dropped from its document's reduce or stitch; the run completes, the
    gang is journaled partial, and both packages agree on every result."""
    mark = POINT_MARK if approach == "skeleton" else MARK
    docs = make_docs(7, n_docs=2, poison=True)
    port, phases, info, partial, _ = streaming(PORT, approach, docs, tmp_path / "p",
                                               poison=mark)
    jax, jax_phases, jax_info, jax_partial, _ = streaming(JAX, approach, docs,
                                                          tmp_path / "j", poison=mark)
    assert _view(port) == _view(jax)
    assert phases == jax_phases and info == jax_info
    assert partial and jax_partial and info["partial"]
    if approach == "mapreduce":
        assert port[0].meta["dropped_chunks"] >= 1 and "dropped_chunks" not in port[1].meta
        assert port[0].summary and MARK not in port[0].summary
    elif approach == "skeleton":
        # every document's third point fails: two of three expansions stitch
        assert [r.meta["dropped_points"] for r in port] == [1, 1]
        assert all(POINT_MARK not in r.summary for r in port)
    else:
        assert all(r.summary for r in port)


def test_tiny_llama_streaming_matches_jax_engine_barrier(tmp_path):
    """The port's streaming map-reduce through TorchBackend(device="cpu")
    over its serving layer equals, byte for byte, the JAX engine's barrier
    route on the same carried f32 weights (JAX dense, the port through its
    kernel wrappers' plain versions). The scheduler's window holds each
    round for its company, so the map round and the reduce round are the
    same engine batches on both routes."""
    from vnsum_tpu.backend.engine import TpuBackend
    from vnsum_tpu_torch.backend.engine import TorchBackend

    from torch_strategy_parity import MAX_NEW, recording
    from torch_strategy_parity import docs as vi_docs
    from test_torch_models_llama import carried_weights

    jcfg, params, model = carried_weights(max_seq_len=2048 + MAX_NEW)
    texts = vi_docs(2)
    knobs = dict(chunk_size=900, chunk_overlap=50, max_new_tokens=MAX_NEW)
    jax_calls, port_calls = [], []
    jax_backend = recording(TpuBackend(model_config=jcfg, params=params, flash=False,
                                       batch_size=8, max_new_tokens=MAX_NEW), jax_calls)
    want = jax_get_strategy("mapreduce", jax_backend, JaxPipelineConfig(
        approach="mapreduce", models=["tiny"], **knobs)).summarize_batch(texts)

    port_backend = recording(TorchBackend(model=model, flash=True, quantize_kv=False,
                                          batch_size=8, max_new_tokens=MAX_NEW,
                                          device="cpu"), port_calls)
    sched = MicroBatchScheduler(port_backend, max_batch=8, max_wait_s=1.0)
    try:
        handle = sched.admit_gang("t")
        view = QueuedBackend(sched, trace_id="t", gang="t")
        strategy = get_strategy("mapreduce", port_backend, PipelineConfig(
            approach="mapreduce", models=["tiny"], **knobs))
        got = strategy.summarize_batch(texts, backend=view)
        handle.finish()
    finally:
        sched.close()
    assert [r.num_chunks for r in got] == [r.num_chunks for r in want]
    assert all(r.num_chunks >= 3 for r in got)
    assert [r.summary for r in got] == [r.summary for r in want]
    assert [(r.llm_calls, r.rounds) for r in got] == [(r.llm_calls, r.rounds) for r in want]
    # one engine call for the map round, one for the reduces, each with
    # the barrier route's prompts (in the order each route submits them)
    # and outputs; random weights write text after some map prompts
    assert len(port_calls) == len(jax_calls) == 2
    for (pp, po), (jp, jo) in zip(port_calls, jax_calls):
        assert sorted(zip(pp, po)) == sorted(zip(jp, jo))
    assert any(o for _, outs in port_calls for o in outs)
