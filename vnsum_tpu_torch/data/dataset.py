"""Filesystem datasets: docs + reference summaries keyed by filename
(ref L0 layer, SURVEY.md §1: data_1/doc/*.txt ↔ data_1/summary/*.txt, plus
the document tree JSON for the hierarchical approach).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

from ..core.logging import get_logger

logger = get_logger("vnsum.data")


@dataclass
class DocStats:
    """Per-corpus stats (ref count_documents, run_full_evaluation_pipeline.py
    :235-322 — WITHOUT its indentation bug that left doc_info empty, SURVEY.md
    §7 'known reference bugs')."""

    total_documents: int = 0
    total_tokens: int = 0
    total_chars: int = 0
    estimated_chunks: int = 0
    per_document: list[dict] = field(default_factory=list)

    @property
    def avg_tokens_per_doc(self) -> float:
        return self.total_tokens / self.total_documents if self.total_documents else 0.0

    def to_dict(self) -> dict:
        return {
            "total_documents": self.total_documents,
            "total_tokens": self.total_tokens,
            "total_chars": self.total_chars,
            "estimated_chunks": self.estimated_chunks,
            "avg_tokens_per_doc": self.avg_tokens_per_doc,
            "per_document": self.per_document,
        }


class DocumentDataset:
    """Paired iteration over a docs dir and a reference-summary dir."""

    def __init__(self, docs_dir: str | Path, summary_dir: str | Path | None = None):
        self.docs_dir = Path(docs_dir)
        self.summary_dir = Path(summary_dir) if summary_dir else None
        if not self.docs_dir.is_dir():
            raise FileNotFoundError(f"docs dir not found: {self.docs_dir}")

    def filenames(self, max_samples: int | None = None) -> list[str]:
        names = sorted(p.name for p in self.docs_dir.glob("*.txt"))
        return names[:max_samples] if max_samples else names

    def read_doc(self, name: str) -> str:
        return (self.docs_dir / name).read_text(encoding="utf-8")

    def has_reference(self, name: str) -> bool:
        return self.summary_dir is not None and (self.summary_dir / name).is_file()

    def read_reference(self, name: str) -> str | None:
        if self.summary_dir is None:
            return None
        p = self.summary_dir / name
        return p.read_text(encoding="utf-8") if p.is_file() else None

    def __iter__(self) -> Iterator[tuple[str, str, str | None]]:
        for name in self.filenames():
            yield name, self.read_doc(name), self.read_reference(name)

    def __len__(self) -> int:
        return len(self.filenames())


def analyze_documents(
    dataset: DocumentDataset,
    count_tokens: Callable[[str], int],
    chunk_size: int | None = None,
    max_samples: int | None = None,
) -> DocStats:
    stats = DocStats()
    for name in dataset.filenames(max_samples):
        text = dataset.read_doc(name)
        tokens = count_tokens(text)
        chunks = max(1, -(-tokens // chunk_size)) if chunk_size else 1
        stats.total_documents += 1
        stats.total_tokens += tokens
        stats.total_chars += len(text)
        stats.estimated_chunks += chunks
        stats.per_document.append(
            {"filename": name, "tokens": tokens, "chars": len(text), "est_chunks": chunks}
        )
    return stats
