"""The port's map-reduce pipeline over data/vi_eval against the JAX
package's, on carried weights: every generated summary file must be
byte-identical and the ROUGE scores equal.

Both engines run their kernels (the JAX ones in interpret mode, the port's
on their plain versions). The decode budget of 128 keeps every cache length
a multiple of 128: the JAX decode kernel's interpret mode pads a ragged last
128-slot block with NaN, which reaches the PV product as 0 * NaN.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import PipelineConfig
from vnsum_tpu_torch.core.faults import call_with_retries, is_retryable
from vnsum_tpu_torch.eval.rouge import RougeScorer
from vnsum_tpu_torch.pipeline import cli
from vnsum_tpu_torch.pipeline.runner import PipelineRunner

from test_torch_eval_embedding import (
    assert_embedding_stats_close,
    carried_embedders,
    tiny_bert_dir,
)
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
DOC_NAMES = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))
MAX_NEW = 128
KNOBS = dict(chunk_size=1024, chunk_overlap=100, token_max=1500, max_new_tokens=MAX_NEW)


def dirs(root: Path) -> dict:
    return dict(
        docs_dir=str(FIXTURE / "doc"),
        summary_dir=str(FIXTURE / "summary"),
        generated_summaries_dir=str(root / "gen"),
        results_dir=str(root / "results"),
        logs_dir=str(root / "logs"),
    )


def test_mapreduce_over_vi_eval_matches_jax(tmp_path):
    jcfg, params, model = carried_weights(max_seq_len=4096)
    jax_embedder, port_embedder = carried_embedders()

    jax_cfg = JaxPipelineConfig(
        approach="mapreduce", models=["tiny"], **dirs(tmp_path / "jax"), **KNOBS
    )
    jax_runner = JaxPipelineRunner(
        jax_cfg,
        backend_factory=lambda _: TpuBackend(
            model_config=jcfg, params=params, flash=True, interpret=True,
            batch_size=8, max_new_tokens=MAX_NEW,
        ),
        embedding_model=jax_embedder,
    )
    want = jax_runner.run()

    engines = []

    def factory(_):
        engines.append(TorchBackend(
            model=model, flash=True, batch_size=8, max_new_tokens=MAX_NEW, device="cpu",
        ))
        return engines[-1]

    cfg = PipelineConfig(approach="mapreduce", models=["tiny"], **dirs(tmp_path / "port"), **KNOBS)
    runner = PipelineRunner(cfg, backend_factory=factory, embedding_model=port_embedder,
                            device="cpu")
    got = runner.run()

    assert runner.failures == []
    rec, jrec = got.summarization["tiny"], want.summarization["tiny"]
    assert rec["successful"] == len(DOC_NAMES) and rec["failed"] == 0
    assert rec["total_chunks"] == jrec["total_chunks"] > len(DOC_NAMES)
    gen = tmp_path / "port" / "gen_mapreduce_tiny"
    jgen = tmp_path / "jax" / "gen_mapreduce_tiny"
    assert sorted(p.name for p in gen.glob("*.txt")) == DOC_NAMES
    for name in DOC_NAMES:
        assert (gen / name).read_bytes() == (jgen / name).read_bytes(), name
    assert any((gen / name).stat().st_size for name in DOC_NAMES)
    assert engines[0].stats.generated_tokens > 0
    assert engines[0].stats.prefill_forwards > 0 and engines[0].stats.decode_steps > 0

    ev = got.evaluation["tiny"]
    assert ev["rouge_scores"] == want.evaluation["tiny"]["rouge_scores"]
    # the embedding metrics, on the same encoder weights as the JAX run's
    assert set(ev) == {"semantic_similarity", "rouge_scores", "bert_scores"}
    assert_embedding_stats_close(ev, want.evaluation["tiny"])
    saved = json.loads(next((tmp_path / "port" / "results").glob("pipeline_results_*.json")).read_text())
    assert saved["results"]["engine"]["tiny"]["prompts"] == engines[0].stats.prompts
    assert "rouge1/2/L" in runner.report() and "bert F1" in runner.report()


def test_cli_runs_on_the_cpu(tmp_path):
    """The CLI with a registry model, random weights from a seed, on the CPU;
    the embedding metrics from an HF BERT checkpoint (--embedding-dir)."""
    bert = tiny_bert_dir(tmp_path / "bert")
    args = [
        "--approach", "mapreduce", "--models", "tiny", "--device", "cpu",
        "--chunk-size", "400", "--max-new-tokens", "8", "--max-samples", "2",
        "--embedding-dir", str(bert),
    ]
    for k, v in dirs(tmp_path).items():
        args += ["--" + k.replace("_", "-"), v]
    assert cli.main(args) == 0
    saved = json.loads(next((tmp_path / "results").glob("pipeline_results_*.json")).read_text())
    rec = saved["results"]["summarization"]["tiny"]
    assert rec["successful"] == 2 and rec["failed"] == 0
    assert saved["config"]["evaluation"]["embedding_dir"] == str(bert)
    ev = saved["results"]["evaluation"]["tiny"]
    for key in ("rouge_scores", "semantic_similarity", "bert_scores"):
        assert all(math.isfinite(v) for v in ev[key].values()), key


def test_cuda_run_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cfg = PipelineConfig(models=["tiny"], **dirs(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PipelineRunner(cfg, device="cuda")


def test_failed_batch_is_reported_not_retried(tmp_path):
    """A device fault arrives as RuntimeError: the batch is not retried, its
    documents are recorded failed, and the CLI-facing failure list is set."""
    calls = []

    class Broken:
        name = "broken"

        def generate(self, prompts, **kw):
            calls.append(len(prompts))
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        def count_tokens(self, text):
            return len(text.encode())

        def count_tokens_batch(self, texts):
            return [len(t.encode()) for t in texts]

    cfg = PipelineConfig(models=["tiny"], max_samples=2, **dirs(tmp_path), **KNOBS)
    runner = PipelineRunner(cfg, backend_factory=lambda _: Broken(), device="cpu")
    runner.run()
    assert len(calls) == 1
    assert runner.results.summarization["tiny"]["failed"] == 2
    # both documents, then the evaluation that found no summaries to score
    assert [f.split(":")[0] for f in runner.failures] == [
        "tiny/ao_dai.txt", "tiny/ca_phe_viet_nam.txt", "tiny",
    ]


@pytest.mark.parametrize(
    "err,retry",
    [(RuntimeError("CUDA error"), False), (ValueError("x"), False),
     (json.JSONDecodeError("x", "", 0), True), (ConnectionError("x"), True),
     (TimeoutError("x"), True)],
)
def test_retry_policy(err, retry):
    assert is_retryable(err) is retry
    calls = []

    def fn():
        calls.append(1)
        raise err

    with pytest.raises(type(err)):
        call_with_retries(fn, max_retries=2, backoff=0.0)
    assert len(calls) == (3 if retry else 1)


def test_rouge_copy_matches_jax_scorer():
    from vnsum_tpu.eval.rouge import RougeScorer as JaxRougeScorer

    for name in DOC_NAMES:
        ref = (FIXTURE / "summary" / name).read_text(encoding="utf-8")
        doc = (FIXTURE / "doc" / name).read_text(encoding="utf-8")
        got = RougeScorer(["rouge1", "rouge2", "rougeL"]).score(ref, doc[:900])
        want = JaxRougeScorer(["rouge1", "rouge2", "rougeL"], use_native=False).score(ref, doc[:900])
        for kind, score in want.items():
            assert (got[kind].precision, got[kind].recall, got[kind].fmeasure) == (
                score.precision, score.recall, score.fmeasure
            )
