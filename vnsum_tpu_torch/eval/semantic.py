"""Summary-folder evaluation: ROUGE per pair, in the reference's results
JSON schema (summary_statistics + detailed_results).

Counterpart of ``vnsum_tpu/eval/semantic.py`` without its embedding
columns: BERTScore and the sentence cosine need the encoder, which is not
ported yet. Their absence is recorded under ``not_computed`` — never as
zeros.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.logging import get_logger
from .rouge import RougeScorer

logger = get_logger("vnsum.eval")

NOT_COMPUTED = ("semantic_similarity", "bert_scores")


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


def evaluate_folders(
    generated_dir: str | Path,
    reference_dir: str | Path,
    max_samples: int | None = None,
    output: str | Path | None = None,
    use_stemmer: bool = True,
) -> dict:
    generated = load_summary_dir(generated_dir)
    references = load_summary_dir(reference_dir)
    common = match_pairs(generated, references, max_samples)
    scorer = RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer)
    detailed = []
    r1, r2, rl = [], [], []
    for fname in common:
        scores = scorer.score(references[fname], generated[fname])
        r1.append(scores["rouge1"].fmeasure)
        r2.append(scores["rouge2"].fmeasure)
        rl.append(scores["rougeL"].fmeasure)
        detailed.append(
            {
                "rouge1_f": scores["rouge1"].fmeasure,
                "rouge2_f": scores["rouge2"].fmeasure,
                "rougeL_f": scores["rougeL"].fmeasure,
                "filename": fname,
            }
        )
    stats = {
        "rouge_scores": {
            "rouge1_f1": float(np.mean(r1)),
            "rouge2_f1": float(np.mean(r2)),
            "rougeL_f1": float(np.mean(rl)),
        },
        "not_computed": list(NOT_COMPUTED),
    }
    results = {"summary_statistics": stats, "detailed_results": detailed}
    if output:
        Path(output).parent.mkdir(parents=True, exist_ok=True)
        Path(output).write_text(
            json.dumps(results, indent=2, ensure_ascii=False), encoding="utf-8"
        )
    return results
