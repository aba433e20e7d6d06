"""Semantic evaluator: per-pair sentence cosine and ROUGE, corpus
BERTScore and, optionally, the LLM judge's G-Eval, in the reference's
results JSON schema (summary_statistics {semantic_similarity, rouge_scores,
bert_scores, llm_scores} + detailed_results).

Counterpart of ``vnsum_tpu/eval/semantic.py``.
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path

import numpy as np

from ..core.logging import get_logger
from .embedding import EmbeddingModel, bert_scores, cosine_similarities
from .rouge import RougeScorer

logger = get_logger("vnsum.eval")


def load_summary_dir(path: str | Path) -> dict[str, str]:
    """filename -> text for every .txt in a directory."""
    out: dict[str, str] = {}
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"summary directory not found: {p}")
    for f in sorted(p.glob("*.txt")):
        out[f.name] = f.read_text(encoding="utf-8")
    return out


def match_pairs(
    generated: dict[str, str],
    references: dict[str, str],
    max_samples: int | None = None,
) -> list[str]:
    """Sorted filenames present on both sides; raises when none match."""
    common = sorted(set(generated) & set(references))
    unpaired = (set(generated) | set(references)) - set(common)
    if unpaired:
        logger.info("skipping %d unpaired files", len(unpaired))
    if max_samples:
        common = common[:max_samples]
    if not common:
        raise ValueError("no common filenames between generated and references")
    return common


class SemanticEvaluator:
    def __init__(
        self,
        embedding_model: EmbeddingModel | None = None,
        use_stemmer: bool = True,
        include_llm_eval: bool = False,
        llm_judge=None,
        tracer=None,
    ) -> None:
        self.embedder = embedding_model or EmbeddingModel()
        self.rouge = RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer)
        self.include_llm_eval = include_llm_eval
        # an eval.LLMJudge; the llm_scores block needs both
        self.llm_judge = llm_judge
        # a core.profiling.Tracer: the embed, bertscore and rouge spans
        self.tracer = tracer

    def _span(self, name: str):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name)

    def evaluate_pairs(
        self,
        generated: dict[str, str],
        references: dict[str, str],
        max_samples: int | None = None,
    ) -> dict:
        """Evaluate matching filenames; returns the results-JSON dict."""
        common = match_pairs(generated, references, max_samples)
        gen_texts = [generated[f] for f in common]
        ref_texts = [references[f] for f in common]

        # one batched embedding pass per side, not one per pair
        with self._span("embed"):
            sims = cosine_similarities(
                self.embedder.sentence_embeddings(gen_texts),
                self.embedder.sentence_embeddings(ref_texts),
            )
        with self._span("bertscore"):
            bert = bert_scores(self.embedder, gen_texts, ref_texts)

        detailed = []
        r1, r2, rl = [], [], []
        for fname, g, r, sim in zip(common, gen_texts, ref_texts, sims):
            with self._span("rouge"):
                scores = self.rouge.score(r, g)
            r1.append(scores["rouge1"].fmeasure)
            r2.append(scores["rouge2"].fmeasure)
            rl.append(scores["rougeL"].fmeasure)
            detailed.append(
                {
                    "semantic_similarity": float(sim),
                    "rouge1_f": scores["rouge1"].fmeasure,
                    "rouge2_f": scores["rouge2"].fmeasure,
                    "rougeL_f": scores["rougeL"].fmeasure,
                    "filename": fname,
                }
            )

        stats = {
            "semantic_similarity": {
                "mean": float(np.mean(sims)),
                "std": float(np.std(sims)),
                "min": float(np.min(sims)),
                "max": float(np.max(sims)),
            },
            "rouge_scores": {
                "rouge1_f1": float(np.mean(r1)),
                "rouge2_f1": float(np.mean(r2)),
                "rougeL_f1": float(np.mean(rl)),
            },
            "bert_scores": {
                "bert_precision": float(np.mean([b.precision for b in bert])),
                "bert_recall": float(np.mean([b.recall for b in bert])),
                "bert_f1": float(np.mean([b.f1 for b in bert])),
            },
        }
        if self.include_llm_eval and self.llm_judge is not None:
            stats["llm_scores"] = self.llm_judge.evaluate(
                {f: generated[f] for f in common},
                {f: references[f] for f in common},
            )
        return {"summary_statistics": stats, "detailed_results": detailed}

    def evaluate_folders(
        self,
        generated_dir: str | Path,
        reference_dir: str | Path,
        max_samples: int | None = None,
        output: str | Path | None = None,
    ) -> dict:
        results = self.evaluate_pairs(
            load_summary_dir(generated_dir),
            load_summary_dir(reference_dir),
            max_samples=max_samples,
        )
        if output:
            Path(output).parent.mkdir(parents=True, exist_ok=True)
            Path(output).write_text(
                json.dumps(results, indent=2, ensure_ascii=False), encoding="utf-8"
            )
        return results
