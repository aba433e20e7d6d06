"""Folder-vs-folder evaluator CLI: ROUGE-1/2/L and BERTScore per file and
in aggregate, written as structured JSON (``--output``).

Counterpart of ``vnsum_tpu/utils/evaluate_summaries.py``; BERTScore runs
through the port's encoder on ``--device`` (the card by default).

    python -m vnsum_tpu_torch.utils.evaluate_summaries GEN_DIR REF_DIR \\
        [--max-samples N] [--no-stemmer] [--skip-bert] [--output OUT.json] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..core.logging import get_logger
from ..eval.embedding import EmbeddingModel, bert_scores
from ..eval.rouge import RougeScorer
from ..eval.semantic import load_summary_dir, match_pairs

logger = get_logger("vnsum.utils.evaluate")


def evaluate_summaries(
    generated_dir: str | Path,
    reference_dir: str | Path,
    *,
    max_samples: int | None = None,
    use_stemmer: bool = True,
    skip_bert: bool = False,
    embedding_model: EmbeddingModel | None = None,
    device="cuda",
) -> dict:
    """Folder-vs-folder ROUGE (+ BERTScore unless ``skip_bert``) over
    matching filenames. Without ``embedding_model``, BERTScore runs a
    random-init encoder on ``device``."""
    generated = load_summary_dir(generated_dir)
    references = load_summary_dir(reference_dir)
    common = match_pairs(generated, references, max_samples)

    scorer = RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer)
    per_file: dict[str, dict] = {}
    for name in common:
        scores = scorer.score(references[name], generated[name])
        per_file[name] = {
            k: {"precision": s.precision, "recall": s.recall, "f1": s.fmeasure}
            for k, s in scores.items()
        }

    def mean(metric: str, field: str) -> float:
        return sum(per_file[n][metric][field] for n in common) / len(common)

    aggregate = {
        m: {f: mean(m, f) for f in ("precision", "recall", "f1")}
        for m in ("rouge1", "rouge2", "rougeL")
    }

    if not skip_bert:
        model = embedding_model or EmbeddingModel(device=device)
        bert = bert_scores(
            model, [generated[n] for n in common], [references[n] for n in common]
        )
        for name, b in zip(common, bert):
            per_file[name]["bert"] = {
                "precision": b.precision, "recall": b.recall, "f1": b.f1,
            }
        aggregate["bert"] = {
            "precision": sum(b.precision for b in bert) / len(bert),
            "recall": sum(b.recall for b in bert) / len(bert),
            "f1": sum(b.f1 for b in bert) / len(bert),
        }

    return {"num_pairs": len(common), "aggregate": aggregate, "per_file": per_file}


def format_report(results: dict) -> str:
    lines = [f"Evaluated {results['num_pairs']} summary pairs", ""]
    for metric, vals in results["aggregate"].items():
        lines.append(
            f"{metric:8s}  P={vals['precision']:.4f}  "
            f"R={vals['recall']:.4f}  F1={vals['f1']:.4f}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="vnsum-torch-evaluate",
        description="Folder-vs-folder ROUGE + BERTScore evaluation",
    )
    p.add_argument("generated_dir")
    p.add_argument("reference_dir")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--no-stemmer", action="store_true")
    p.add_argument("--skip-bert", action="store_true",
                   help="ROUGE only (no encoder / device work)")
    p.add_argument("--output", default=None, help="write full results JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    results = evaluate_summaries(
        args.generated_dir,
        args.reference_dir,
        max_samples=args.max_samples,
        use_stemmer=not args.no_stemmer,
        skip_bert=args.skip_bert,
        device=args.device,
    )
    print(format_report(results))
    if args.output:
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(
            json.dumps(results, indent=2, ensure_ascii=False), encoding="utf-8"
        )
        logger.info("results written to %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
