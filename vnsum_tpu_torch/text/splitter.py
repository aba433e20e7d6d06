"""Token-aware recursive text splitting.

Re-implements the splitting semantics the reference gets from langchain's
RecursiveCharacterTextSplitter with keep_separator=True
(construction at run_full_evaluation_pipeline.py:356-361; Vietnamese-friendly
separator ladder ["\\n\\n", "\\n", ".", "!", "?", ";", " ", ""]) so that
chunk boundaries match the reference runs. The length function is pluggable;
the reference passes HF `tokenizer.encode` (:348-349).
"""
from __future__ import annotations

import re
from typing import Callable, Sequence

VIETNAMESE_SEPARATORS: tuple[str, ...] = ("\n\n", "\n", ".", "!", "?", ";", " ", "")


class RecursiveTokenSplitter:
    """Recursively split text on a separator ladder, then greedily merge
    pieces into chunks of at most ``chunk_size`` (per ``length_function``)
    with ``chunk_overlap`` carry-over between consecutive chunks.

    Separators are kept and attached to the *following* piece (langchain's
    keep_separator=True behavior), so no characters are lost except the
    strip() at chunk joins.
    """

    def __init__(
        self,
        chunk_size: int,
        chunk_overlap: int = 0,
        length_function: Callable[[str], int] = len,
        separators: Sequence[str] = VIETNAMESE_SEPARATORS,
        length_batch_function: Callable[[Sequence[str]], list[int]] | None = None,
    ) -> None:
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.length_function = length_function
        # one tokenizer call per split level instead of one per PIECE: a
        # reference-scale doc splits into thousands of sentence pieces, and
        # per-piece HF encode calls dominated the pipeline's host time.
        # Semantics are identical — batch(l) must equal [length(p) for p]
        self.length_batch = length_batch_function or (
            lambda texts: [length_function(t) for t in texts]
        )
        self.separators = list(separators)

    # -- public API --------------------------------------------------------

    def split_text(self, text: str) -> list[str]:
        if not text:
            return []
        return self._split(text, self.separators)

    # -- internals ---------------------------------------------------------

    def _split_on(self, text: str, separator: str) -> list[str]:
        """Split keeping the separator glued to the following piece."""
        if separator == "":
            return [c for c in text]
        parts = re.split(f"({re.escape(separator)})", text)
        out: list[str] = []
        if parts[0]:
            out.append(parts[0])
        for i in range(1, len(parts) - 1, 2):
            merged = parts[i] + parts[i + 1]
            if merged:
                out.append(merged)
        return [p for p in out if p]

    def _split(self, text: str, separators: Sequence[str]) -> list[str]:
        # pick the first separator present in the text (or the terminal "")
        separator = separators[-1]
        next_separators: Sequence[str] = []
        for i, sep in enumerate(separators):
            if sep == "":
                separator = sep
                break
            if sep in text:
                separator = sep
                next_separators = separators[i + 1 :]
                break

        splits = self._split_on(text, separator)
        lens = self.length_batch(splits)  # counted ONCE per level

        chunks: list[str] = []
        small: list[tuple[str, int]] = []
        for piece, plen in zip(splits, lens):
            if plen < self.chunk_size:
                small.append((piece, plen))
            else:
                if small:
                    chunks.extend(self._merge_counted(small))
                    small = []
                if not next_separators:
                    chunks.append(piece)
                else:
                    chunks.extend(self._split(piece, next_separators))
        if small:
            chunks.extend(self._merge_counted(small))
        return chunks

    def _merge_counted(self, counted: list[tuple[str, int]]) -> list[str]:
        """Greedy merge of already-small (piece, length) pairs into
        ≤chunk_size chunks, keeping a chunk_overlap-sized tail of pieces
        between chunks. Lengths arrive precomputed from the per-level
        batch count in _split — never recounted here."""
        pieces = [p for p, _ in counted]
        lengths = [n for _, n in counted]
        chunks: list[str] = []
        window: list[str] = []
        window_lens: list[int] = []
        total = 0
        for piece, plen in zip(pieces, lengths):
            if total + plen > self.chunk_size and window:
                joined = "".join(window).strip()
                if joined:
                    chunks.append(joined)
                # drop from the front until within overlap budget (and room
                # for the incoming piece)
                while window and (
                    total > self.chunk_overlap
                    or (total + plen > self.chunk_size and total > 0)
                ):
                    total -= window_lens[0]
                    window.pop(0)
                    window_lens.pop(0)
            window.append(piece)
            window_lens.append(plen)
            total += plen
        joined = "".join(window).strip()
        if joined:
            chunks.append(joined)
        return chunks
