"""Structured run records.

Copy of the offline-pipeline records of ``vnsum_tpu/core/results.py``,
keeping the reference's pipeline_results JSON schema
(run_full_evaluation_pipeline.py:927-947: pipeline_info / config / results
{document_stats, summarization, evaluation}).
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class DocumentRecord:
    """Per-document processing details (ref :575-582).

    `num_chunks` and `llm_calls` are true per-document counts; the
    processing time is the document's even share of its batch's wall clock
    (see ModelRunRecord.time_basis)."""

    filename: str
    num_chunks: int
    processing_time: float
    summary_length_chars: int
    llm_calls: int = 0
    status: str = "success"
    error: str | None = None


@dataclass
class ModelRunRecord:
    """Per-model summarization stats (ref :586-607)."""

    model: str
    approach: str
    total_documents: int = 0
    successful: int = 0
    failed: int = 0
    total_chunks: int = 0
    total_time: float = 0.0
    status: str = "success"
    error: str | None = None
    time_basis: str = "batch_amortized"
    processing_details: list[DocumentRecord] = field(default_factory=list)

    @property
    def avg_processing_time_per_doc(self) -> float:
        return self.total_time / self.total_documents if self.total_documents else 0.0

    @property
    def chunks_per_second(self) -> float:
        return self.total_chunks / self.total_time if self.total_time else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["avg_processing_time_per_doc"] = self.avg_processing_time_per_doc
        d["chunks_per_second"] = self.chunks_per_second
        return d


@dataclass
class PipelineResults:
    """Top-level run record, persisted as
    evaluation_results/pipeline_results_<ts>.json (ref :927-947)."""

    config: dict
    start_time: float = field(default_factory=time.time)
    document_stats: dict = field(default_factory=dict)
    summarization: dict[str, Any] = field(default_factory=dict)
    evaluation: dict[str, Any] = field(default_factory=dict)
    engine: dict[str, Any] = field(default_factory=dict)

    def add_summarization(self, record: ModelRunRecord) -> None:
        self.summarization[record.model] = record.to_dict()

    def add_evaluation(self, model: str, metrics: dict) -> None:
        self.evaluation[model] = metrics

    def to_dict(self) -> dict:
        end = time.time()
        return {
            "pipeline_info": {
                "timestamp": time.strftime(
                    "%Y-%m-%dT%H:%M:%S", time.localtime(self.start_time)
                ),
                "duration_seconds": end - self.start_time,
                "approach": self.config.get("approach"),
                "framework": "vnsum_tpu_torch",
            },
            "config": self.config,
            "results": {
                "document_stats": self.document_stats,
                "summarization": self.summarization,
                "evaluation": self.evaluation,
                "engine": self.engine,
            },
        }

    def save(self, results_dir: str | Path) -> Path:
        out = Path(results_dir)
        out.mkdir(parents=True, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = out / f"pipeline_results_{ts}.json"
        n = 1
        while path.exists():
            path = out / f"pipeline_results_{ts}_{n}.json"
            n += 1
        path.write_text(
            json.dumps(self.to_dict(), indent=2, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        return path
