"""Batch evaluation pipeline on the port's engine.

Counterpart of ``vnsum_tpu/pipeline/runner.py``: preflight → document
analysis → per model, summarization with resume-by-file → evaluation
(ROUGE, sentence cosine, BERTScore and, with ``include_llm_eval``, the
G-Eval judge) → report → results JSON. Documents go to the strategy in
groups, so every LLM call of a round shares device batches.
``PipelineConfig.backend`` picks the summarizer: ``torch`` (the port's
engine; the model is a registry config with random weights, or an HF
checkpoint, ``weights_dir``, either with int8 weights, ``quantize``, and
W8A8 prefill with ``quantize_act``), ``ollama`` (a local server) or
``fake`` (the test double).

Failure containment differs from the JAX package in one way: device errors
(``RuntimeError``) are never retried (core/faults.py), and
:func:`PipelineRunner.run` reports every failed document and model in
``failures`` so the CLI can exit non-zero.
"""
from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import torch

from ..backend.base import Backend, get_backend
from ..backend.engine import TorchBackend, resolve_device
from ..core.config import PipelineConfig
from ..core.faults import call_with_retries, is_retryable
from ..core.logging import get_logger, setup_run_logging
from ..core.results import DocumentRecord, ModelRunRecord, PipelineResults
from ..data import DocumentDataset, analyze_documents
from ..eval import EmbeddingModel, LLMJudge, SemanticEvaluator
from ..models import MODEL_REGISTRY
from ..models.convert import load_hf_checkpoint
from ..strategies import get_strategy
from ..text import DocumentTree, clean_thinking_tokens

logger = get_logger("vnsum.pipeline")


def model_name_safe(model: str) -> str:
    """'llama3.2:3b' -> 'llama3_2_3b' (ref :170, :326)."""
    return model.replace(":", "_").replace(".", "_")


def torch_model_args(model: str, weights_dir: str | None, tokenizer: str, dtype: str,
                     device) -> dict:
    """TorchBackend's model and tokenizer arguments. With ``weights_dir``,
    the checkpoint loaded onto ``device`` and its own tokenizer,
    ``hf:<weights_dir>``, unless ``tokenizer`` names an ``hf:`` one;
    otherwise the registry's config for ``model``, whose weights the
    backend draws from its seed. The pipeline runner and the server build
    their engines through this."""
    if weights_dir:
        _, loaded = load_hf_checkpoint(weights_dir, dtype=getattr(torch, dtype), device=device)
        tok = tokenizer if tokenizer.startswith("hf:") else f"hf:{weights_dir}"
        return {"model": loaded, "tokenizer": tok}
    if model not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model!r}; have {sorted(MODEL_REGISTRY)}")
    return {"model_config": MODEL_REGISTRY[model](), "tokenizer": tokenizer}


class PipelineRunner:
    def __init__(
        self,
        config: PipelineConfig,
        backend_factory=None,
        embedding_model: EmbeddingModel | None = None,
        llm_judge: LLMJudge | None = None,
        device="cuda",
    ) -> None:
        self.config = config
        # a run asked to use the card raises here when none is visible
        self.device = resolve_device(device)
        self.backend_factory = backend_factory or self._default_backend_factory
        # built on first use, then reused across the models of the run
        self.embedding_model = embedding_model
        # a prebuilt judge (tests, the card check); None = resolved from
        # EvalConfig by _build_llm_judge
        self.llm_judge = llm_judge
        self.results = PipelineResults(config=config.to_dict())
        self.failures: list[str] = []
        self.log_path = setup_run_logging(config.logs_dir)
        logger.info("pipeline configured: approach=%s backend=%s models=%s device=%s",
                    config.approach, config.backend, config.models, self.device)
        if clean_thinking_tokens("<think>x</think>ok") != "ok":
            raise RuntimeError("thinking-token cleaner self-check failed")

    # -- backend -----------------------------------------------------------

    def _default_backend_factory(self, model: str) -> Backend:
        cfg = self.config
        if cfg.backend == "ollama":
            return get_backend(
                "ollama", model=model, url=cfg.ollama_url,
                max_new_tokens=cfg.max_new_tokens,
            )
        if cfg.backend == "fake":
            return get_backend("fake")
        if cfg.backend == "torch":
            return TorchBackend(
                **self._resolve_model(model),
                batch_size=cfg.batch_size,
                max_new_tokens=cfg.max_new_tokens,
                prefill_chunk_tokens=cfg.prefill_chunk_tokens,
                quantize=cfg.quantize,
                quantize_act=cfg.quantize_act,
                device=self.device,
            )
        raise ValueError(f"unknown backend {cfg.backend!r}")

    def _resolve_model(self, model: str) -> dict:
        cfg = self.config
        return torch_model_args(model, cfg.weights_dir, cfg.tokenizer, cfg.dtype, self.device)

    def preflight(self, backend: Backend) -> None:
        """Device check before any work: a run asked to use the card fails
        here when no card is visible, instead of carrying on elsewhere."""
        logger.info("backend: %s", backend.name)
        if self.device.type == "cuda":
            resolve_device(self.device)
            logger.info("cuda device: %s", torch.cuda.get_device_name(self.device))

    # -- phases ------------------------------------------------------------

    def analyze(self) -> dict:
        cfg = self.config
        ds = DocumentDataset(cfg.docs_dir, cfg.summary_dir)
        stats = analyze_documents(
            ds, lambda t: len(t.split()), chunk_size=cfg.chunk_size,
            max_samples=cfg.max_samples,
        )
        d = stats.to_dict()
        d["per_document"] = d["per_document"][:1000]
        self.results.document_stats = d
        logger.info(
            "analyzed %d docs: %d tokens total, ~%.0f/doc",
            stats.total_documents, stats.total_tokens, stats.avg_tokens_per_doc,
        )
        return d

    def _output_dir(self, model: str) -> Path:
        # ref naming: <generated_summaries_dir>_<approach>_<model_safe> (:408)
        return Path(
            f"{self.config.generated_summaries_dir}_"
            f"{self.config.approach}_{model_name_safe(model)}"
        )

    def run_summarization_for_model(self, model: str) -> ModelRunRecord:
        cfg = self.config
        record = ModelRunRecord(model=model, approach=cfg.approach)
        t_start = time.time()

        backend = self.backend_factory(model)
        self.preflight(backend)
        strategy = get_strategy(cfg.approach, backend, cfg)

        ds = DocumentDataset(cfg.docs_dir, cfg.summary_dir)
        out_dir = self._output_dir(model)
        out_dir.mkdir(parents=True, exist_ok=True)

        tree = None
        if cfg.approach == "mapreduce_hierarchical":
            tree_path = Path(cfg.tree_json_path)
            if tree_path.is_file():
                tree = DocumentTree.load(tree_path)
            else:
                logger.warning(
                    "tree JSON %s missing; hierarchical will wrap plain text",
                    tree_path,
                )

        pending: list[str] = []
        for name in ds.filenames(cfg.max_samples):
            if (out_dir / name).is_file():  # resume-by-file (ref :422-431)
                logger.info("  %s: already exists, skipping", name)
                continue
            if cfg.summary_dir and not ds.has_reference(name):
                logger.warning("  %s: no reference summary, skipping", name)
                continue
            pending.append(name)
        logger.info("model %s: %d docs pending", model, len(pending))

        group_size = cfg.doc_group_size or 4 * max(cfg.batch_size, 1)
        for start in range(0, len(pending), group_size):
            group = pending[start : start + group_size]
            batch_t0 = time.time()

            def run_batch():
                if tree is None:
                    texts = [ds.read_doc(n) for n in group]
                    return list(zip(group, strategy.summarize_batch(texts)))
                # hierarchical over trees: documents with a tree collapse
                # it bottom-up; the rest wrap their plain text
                roots = [(n, tree.get(n)) for n in group]
                with_tree = [(n, r) for n, r in roots if r is not None]
                fallback = [n for n, r in roots if r is None]
                results = []
                if with_tree:
                    results += zip([n for n, _ in with_tree],
                                   strategy.summarize_tree_batch([r for _, r in with_tree]))
                if fallback:
                    results += zip(fallback, strategy.summarize_batch(
                        [ds.read_doc(n) for n in fallback]))
                return results

            try:
                results = call_with_retries(
                    run_batch,
                    max_retries=cfg.max_batch_retries,
                    backoff=cfg.retry_backoff,
                    should_retry=is_retryable,
                    what=f"batch of {len(group)} docs",
                )
            except Exception as e:
                logger.error("batch failed (%s): %s", group, e)
                logger.debug("%s", traceback.format_exc())
                for name in group:
                    record.failed += 1
                    record.total_documents += 1
                    record.processing_details.append(
                        DocumentRecord(
                            name, 0, time.time() - batch_t0, 0,
                            status="failed", error=str(e),
                        )
                    )
                    self.failures.append(f"{model}/{name}: {e}")
                continue

            batch_time = time.time() - batch_t0
            per_doc_time = batch_time / max(len(results), 1)
            for name, res in results:
                summary = clean_thinking_tokens(res.summary)  # ref :560-561
                (out_dir / name).write_text(summary, encoding="utf-8")
                record.total_documents += 1
                record.successful += 1
                record.total_chunks += res.num_chunks
                record.processing_details.append(
                    DocumentRecord(
                        name, res.num_chunks, per_doc_time, len(summary),
                        llm_calls=res.llm_calls,
                    )
                )
            logger.info(
                "  batch of %d docs in %.1fs (%.1fs/doc)",
                len(results), batch_time, per_doc_time,
            )

        record.total_time = time.time() - t_start
        self.results.add_summarization(record)
        stats = getattr(backend, "stats", None)
        if stats is not None:
            self.results.engine[model] = stats.to_dict()
        return record

    def run_evaluation_for_model(self, model: str) -> dict:
        cfg = self.config
        if self.embedding_model is None:
            ev = cfg.evaluation
            self.embedding_model = (
                EmbeddingModel.from_hf(ev.embedding_dir, batch_size=ev.bert_batch_size,
                                       device=self.device)
                if ev.embedding_dir
                else EmbeddingModel(batch_size=ev.bert_batch_size, device=self.device)
            )
        judge = self._build_llm_judge() if cfg.evaluation.include_llm_eval else None
        evaluator = SemanticEvaluator(
            self.embedding_model, include_llm_eval=judge is not None, llm_judge=judge)
        out_path = Path(cfg.results_dir) / f"{model_name_safe(model)}_results.json"
        results = evaluator.evaluate_folders(
            self._output_dir(model), cfg.summary_dir,
            max_samples=cfg.evaluation.max_samples or cfg.max_samples, output=out_path,
        )
        self.results.add_evaluation(model, results["summary_statistics"])
        return results

    def _build_llm_judge(self) -> LLMJudge | None:
        """The G-Eval judge: an injected judge wins, then a local
        Backend-protocol judge (EvalConfig.judge_backend, the offline path),
        then an OpenRouter-compatible endpoint when an API key is set;
        otherwise None, with a warning: never a hard failure."""
        cfg = self.config.evaluation
        if self.llm_judge is not None:
            return self.llm_judge
        if cfg.judge_backend:
            return LLMJudge(backend=self._judge_backend(cfg.judge_backend))
        api_key = os.environ.get("OPENROUTER_API_KEY") or os.environ.get("OPENAI_API_KEY")
        if not api_key:
            logger.warning(
                "include_llm_eval=True but no OPENROUTER_API_KEY/OPENAI_API_KEY "
                "set; skipping G-Eval"
            )
            return None
        base = (
            "https://openrouter.ai/api/v1"
            if cfg.use_openrouter
            else "https://api.openai.com/v1"
        )
        return LLMJudge(api_base=base, api_key=api_key, model=cfg.llm_model)

    def _judge_backend(self, spec: str) -> Backend:
        """EvalConfig.judge_backend as a judge Backend: "fake" (CI),
        "ollama:<model>" (a local server) or "torch:<registry-name>" (the
        port's engine on the runner's device with RANDOM weights, 64 new
        tokens: plumbing and containment runs only)."""
        name, _, arg = spec.partition(":")
        if name == "fake":
            return get_backend("fake")
        if name == "ollama":
            if not arg:
                raise ValueError(
                    "judge_backend='ollama:<model>' needs the model tag"
                )
            return get_backend("ollama", model=arg, url=self.config.ollama_url)
        if name == "torch":
            if arg not in MODEL_REGISTRY:
                raise ValueError(
                    "judge_backend='torch:<model>' needs a registry model "
                    f"name (have {sorted(MODEL_REGISTRY)}); a bare 'torch' "
                    "would silently judge with an unspecified model"
                )
            logger.warning(
                "torch judge %r runs RANDOM-INIT weights on this host — "
                "scores will mostly fail to parse; use an HTTP judge or "
                "inject PipelineRunner(llm_judge=...) for real judging",
                arg,
            )
            return get_backend(
                "torch", model_config=MODEL_REGISTRY[arg](), max_new_tokens=64,
                device=self.device,
            )
        raise ValueError(f"unknown judge_backend spec {spec!r}")

    # -- orchestration -----------------------------------------------------

    def run(self) -> PipelineResults:
        self.analyze()
        for model in self.config.models:
            try:
                self.run_summarization_for_model(model)
            except Exception as e:
                logger.error("model %s summarization failed: %s", model, e)
                logger.debug("%s", traceback.format_exc())
                self.results.add_summarization(ModelRunRecord(
                    model=model, approach=self.config.approach,
                    status="failed", error=str(e),
                ))
                self.failures.append(f"{model}: summarization failed: {e}")
                continue
            try:
                self.run_evaluation_for_model(model)
            except Exception as e:
                logger.error("model %s evaluation failed: %s", model, e)
                self.results.add_evaluation(model, {"status": "failed", "error": str(e)})
                self.failures.append(f"{model}: evaluation failed: {e}")
        path = self.results.save(self.config.results_dir)
        logger.info("results saved to %s", path)
        self.report()
        return self.results

    def report(self) -> str:
        lines = ["", "=" * 60, "PIPELINE SUMMARY", "=" * 60]
        lines.append(f"approach: {self.config.approach}")
        for model, rec in self.results.summarization.items():
            lines.append(f"\nmodel {model}:")
            lines.append(
                f"  docs: {rec.get('successful', 0)} ok / {rec.get('failed', 0)} failed, "
                f"chunks: {rec.get('total_chunks', 0)}, "
                f"time: {rec.get('total_time', 0.0):.1f}s "
                f"({rec.get('chunks_per_second', 0.0):.2f} chunks/s)"
            )
            ev = self.results.evaluation.get(model)
            if ev and "rouge_scores" in ev:
                rs = ev["rouge_scores"]
                lines.append(
                    f"  rouge1/2/L: {rs['rouge1_f1']:.4f} / "
                    f"{rs['rouge2_f1']:.4f} / {rs['rougeL_f1']:.4f}"
                )
                lines.append(
                    f"  bert F1: {ev['bert_scores']['bert_f1']:.4f}  "
                    f"semsim: {ev['semantic_similarity']['mean']:.4f}"
                )
        text = "\n".join(lines)
        logger.info("%s", text)
        return text
