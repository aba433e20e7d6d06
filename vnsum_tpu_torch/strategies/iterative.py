"""Iterative refinement strategy (copy of
``vnsum_tpu/strategies/iterative.py``).

Semantics follow runners/run_summarization_ollama_iterative.py:102-210: the
first chunk seeds a foundation summary, then each subsequent chunk triggers a
full rewrite integrating the new information. Per document the chain is
inherently sequential, so batching happens ACROSS documents: round r submits
chunk r of every document that still has one as a single backend batch.
"""
from __future__ import annotations

from ..backend.base import Backend
from ..text.splitter import RecursiveTokenSplitter
from .base import StrategyResult, _BatchCounter, register_strategy
from .prompts import ITERATIVE_INITIAL, ITERATIVE_REFINE, template_header

# the refine prompt up to (not including) {context}: header + the carried
# existing_answer — a refine round re-prefills the whole prior summary
# verbatim, so the cache_hint covers it, not just the header
_REFINE_PREFIX = ITERATIVE_REFINE[: ITERATIVE_REFINE.find("{context}")]


@register_strategy
class IterativeStrategy:
    name = "iterative"

    def __init__(
        self,
        backend: Backend,
        splitter: RecursiveTokenSplitter,
        max_new_tokens: int | None = None,
    ) -> None:
        self.backend = backend
        self.splitter = splitter
        self.max_new_tokens = max_new_tokens

    @classmethod
    def from_config(cls, backend: Backend, config, **kw):
        splitter = RecursiveTokenSplitter(
            config.iterative_chunk_size,
            config.iterative_chunk_overlap,
            length_function=backend.count_tokens,
            length_batch_function=getattr(backend, "count_tokens_batch", None),
        )
        return cls(backend, splitter, max_new_tokens=config.max_new_tokens, **kw)

    def summarize_batch(
        self, docs: list[str], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        gen = _BatchCounter(backend or self.backend, self.max_new_tokens)
        chunks_per_doc = [self.splitter.split_text(d) or [d] for d in docs]
        summaries = [""] * len(docs)
        max_rounds = max(len(c) for c in chunks_per_doc) if docs else 0

        for r in range(max_rounds):
            idx = [di for di, c in enumerate(chunks_per_doc) if r < len(c)]
            if r == 0:
                prompts = [
                    ITERATIVE_INITIAL.format(context=chunks_per_doc[di][0])
                    for di in idx
                ]
                # speculation references: the seed summary extracts from
                # its chunk
                refs = [chunks_per_doc[di][0] for di in idx]
                hints = [template_header(ITERATIVE_INITIAL)] * len(idx)
            else:
                prompts = [
                    ITERATIVE_REFINE.format(
                        existing_answer=summaries[di],
                        context=chunks_per_doc[di][r],
                    )
                    for di in idx
                ]
                # a refine rewrite mostly re-emits the existing summary with
                # spans of the new chunk folded in — both are draftable
                refs = [
                    summaries[di] + "\n\n" + chunks_per_doc[di][r]
                    for di in idx
                ]
                # the cacheable prefix of a refine prompt is the header PLUS
                # the re-fed prior summary (everything before the new chunk)
                hints = [
                    _REFINE_PREFIX.format(existing_answer=summaries[di])
                    for di in idx
                ]
            outs = gen(prompts, owners=idx, references=refs, cache_hints=hints)
            for di, out in zip(idx, outs):
                summaries[di] = out

        return [
            StrategyResult(
                summary=summaries[di],
                num_chunks=len(chunks_per_doc[di]),
                llm_calls=gen.calls_by_owner.get(di, 0),
                rounds=len(chunks_per_doc[di]),
            )
            for di in range(len(docs))
        ]

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]
