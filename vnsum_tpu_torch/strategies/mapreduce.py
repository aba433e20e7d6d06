"""Map-reduce strategy (copy of the batch path of
``vnsum_tpu/strategies/mapreduce.py``).

Semantics follow runners/run_summarization_ollama_mapreduce.py:75-201: split →
map each chunk → collapse groups while the whitespace-token total exceeds
token_max → one final reduce. The map step for a batch of documents is one
backend.generate call, and each collapse round batches every group of every
document still collapsing. (The JAX package's streaming path for the
serving layer is not ported.)
"""
from __future__ import annotations

from typing import Callable

from ..backend.base import Backend
from ..text.splitter import RecursiveTokenSplitter
from ..text.tokenizer import whitespace_token_count
from .base import StrategyResult, _BatchCounter, register_strategy, split_by_token_budget
from .prompts import MAPREDUCE_MAP, MAPREDUCE_REDUCE, template_header


@register_strategy
class MapReduceStrategy:
    name = "mapreduce"

    def __init__(
        self,
        backend: Backend,
        splitter: RecursiveTokenSplitter,
        token_max: int = 10000,
        max_new_tokens: int | None = None,
        max_collapse_rounds: int = 10,
        count: Callable[[str], int] = whitespace_token_count,
        map_prompt: str = MAPREDUCE_MAP,
        reduce_prompt: str = MAPREDUCE_REDUCE,
    ) -> None:
        self.backend = backend
        self.splitter = splitter
        self.token_max = token_max
        self.max_new_tokens = max_new_tokens
        # collapse backstop, like the reference's recursion_limit=10 (:196)
        self.max_collapse_rounds = max_collapse_rounds
        self.count = count
        self.map_prompt = map_prompt
        self.reduce_prompt = reduce_prompt

    @classmethod
    def from_config(cls, backend: Backend, config, **kw):
        splitter = RecursiveTokenSplitter(
            config.chunk_size, config.chunk_overlap,
            length_function=backend.count_tokens,
            length_batch_function=getattr(backend, "count_tokens_batch", None),
        )
        return cls(
            backend, splitter, token_max=config.token_max,
            max_new_tokens=config.max_new_tokens, **kw,
        )

    def _reduce_one(self, texts: list[str]) -> str:
        return self.reduce_prompt.format(docs="\n\n".join(texts))

    def summarize_batch(
        self, docs: list[str], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        gen = _BatchCounter(backend or self.backend, self.max_new_tokens)

        chunks_per_doc = [self.splitter.split_text(d) or [d] for d in docs]
        results = [
            StrategyResult(summary="", num_chunks=len(c)) for c in chunks_per_doc
        ]

        # map: every chunk of every document in one batch. The chunk rides
        # along as the speculation reference (a map summary largely re-emits
        # its chunk) and the template header as the cache hint
        flat = [
            (di, self.map_prompt.format(content=c), c)
            for di, chunks in enumerate(chunks_per_doc)
            for c in chunks
        ]
        outs = gen(
            [p for _, p, _ in flat],
            owners=[di for di, _, _ in flat],
            references=[c for _, _, c in flat],
            cache_hints=[template_header(self.map_prompt)] * len(flat),
        )
        summaries: list[list[str]] = [[] for _ in docs]
        for (di, _, _), out in zip(flat, outs):
            summaries[di].append(out)

        # collapse + final rounds, merged: a document whose summaries already
        # fit token_max submits its final reduce in the same batch as the
        # other documents' collapse groups (both use the reduce template).
        # Prompt contents are identical to the sequential formulation
        final_texts: dict[int, str] = {}
        for round_no in range(self.max_collapse_rounds + 1):
            over = [
                di
                for di, s in enumerate(summaries)
                if di not in final_texts
                and sum(self.count(x) for x in s) > self.token_max
            ]
            ready = [
                di for di in range(len(docs))
                if di not in final_texts and di not in over
            ]
            if round_no == self.max_collapse_rounds and over:
                # collapse budget exhausted (ref recursion_limit=10, :196):
                # force the final over whatever remains
                ready += over
                over = []
            batch: list[tuple[str, int, int]] = []
            prompts: list[str] = []
            refs: list[str] = []
            for di in ready:
                batch.append(("final", di, 0))
                prompts.append(self._reduce_one(summaries[di]))
                # reduce output re-emits spans of the summaries it merges
                refs.append("\n\n".join(summaries[di]))
            grouped: dict[int, list[list[str]]] = {}
            for di in over:
                groups = split_by_token_budget(summaries[di], self.token_max, self.count)
                grouped[di] = groups
                for gi, g in enumerate(groups):
                    batch.append(("collapse", di, gi))
                    prompts.append(self._reduce_one(g))
                    refs.append("\n\n".join(g))
            if not prompts:
                break
            outs = gen(
                prompts, owners=[di for _, di, _ in batch], references=refs,
                cache_hints=[template_header(self.reduce_prompt)] * len(prompts),
            )
            for di in over:
                summaries[di] = [None] * len(grouped[di])  # type: ignore[list-item]
            for (kind, di, gi), out in zip(batch, outs):
                if kind == "final":
                    final_texts[di] = out
                else:
                    summaries[di][gi] = out
            for di in over:
                results[di].rounds += 1

        for di, r in enumerate(results):
            r.summary = final_texts[di]
            r.llm_calls = gen.calls_by_owner.get(di, 0)
        return results

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]
