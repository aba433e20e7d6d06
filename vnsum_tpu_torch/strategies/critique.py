"""Map-reduce with integrated self-critique (copy of
``vnsum_tpu/strategies/critique.py``).

Semantics follow runners/run_summarization_ollama_mapreduce_critique.py:112-374:
every collapse group goes reduce → critique → (if issues) refine, with
[PHẦN i] section tags and the literal accept-string check; original chunks are
the critique reference, aligned positionally by cursor; the final reduce uses
the intermediate summaries as critique context, recursively collapsing them
first when they exceed token_max // 2.

The reduce/critique/refine triple runs as three backend batches per round,
shared across every group of every document in the batch.
"""
from __future__ import annotations

from typing import Callable

from ..backend.base import Backend
from ..text.splitter import RecursiveTokenSplitter
from ..text.tokenizer import whitespace_token_count
from .base import StrategyResult, _BatchCounter, register_strategy, split_by_token_budget
from .prompts import (
    CRITIQUE_ACCEPT_STRINGS,
    CRITIQUE_CRITIQUE,
    CRITIQUE_MAP,
    CRITIQUE_REDUCE,
    CRITIQUE_REFINE,
    template_header,
)

_REF_JOIN = "\n\n---\n\n"


def _tag_sections(texts: list[str]) -> str:
    """[PHẦN i] tagging (ref :228-233)."""
    return "\n\n".join(f"[PHẦN {i + 1}]\n{t}" for i, t in enumerate(texts))


@register_strategy
class MapReduceCritiqueStrategy:
    name = "mapreduce_critique"

    def __init__(
        self,
        backend: Backend,
        splitter: RecursiveTokenSplitter,
        token_max: int = 10000,
        max_critique_iterations: int = 2,
        max_new_tokens: int | None = None,
        max_collapse_rounds: int = 15,
        count: Callable[[str], int] = whitespace_token_count,
    ) -> None:
        self.backend = backend
        self.splitter = splitter
        self.token_max = token_max
        self.max_critique_iterations = max_critique_iterations
        self.max_new_tokens = max_new_tokens
        # backstop like the reference's recursion_limit=15 (:438)
        self.max_collapse_rounds = max_collapse_rounds
        self.count = count

    @classmethod
    def from_config(cls, backend: Backend, config, **kw):
        splitter = RecursiveTokenSplitter(
            config.chunk_size, config.chunk_overlap,
            length_function=backend.count_tokens,
            length_batch_function=getattr(backend, "count_tokens_batch", None),
        )
        return cls(
            backend, splitter, token_max=config.token_max,
            max_critique_iterations=config.max_critique_iterations,
            max_new_tokens=config.max_new_tokens, **kw,
        )

    # one batched reduce→critique→refine pass over (texts, refs, iteration);
    # ``owners`` maps each item to its document for per-doc call accounting
    def _reduce_with_critique_batch(
        self,
        gen: _BatchCounter,
        items: list[tuple[list[str], list[str], int]],
        owners: list[int],
    ) -> list[str]:
        summaries = gen(
            [CRITIQUE_REDUCE.format(docs=_tag_sections(texts)) for texts, _, _ in items],
            owners=owners,
            cache_hints=[template_header(CRITIQUE_REDUCE)] * len(items),
        )
        need = [
            i for i, (_, _, it) in enumerate(items)
            if it < self.max_critique_iterations
        ]
        # an empty round is no call: _BatchCounter returns [] for no prompts
        critiques = gen(
            [
                CRITIQUE_CRITIQUE.format(
                    summary=summaries[i],
                    original_chunks=_REF_JOIN.join(items[i][1]),
                )
                for i in need
            ],
            owners=[owners[i] for i in need],
            cache_hints=[template_header(CRITIQUE_CRITIQUE)] * len(need),
        )
        refine_idx: list[int] = []
        refine_prompts: list[str] = []
        for i, crit in zip(need, critiques):
            low = crit.lower()
            if any(s in low for s in CRITIQUE_ACCEPT_STRINGS):
                continue
            refine_idx.append(i)
            refine_prompts.append(
                CRITIQUE_REFINE.format(
                    current_summary=summaries[i],
                    critique=crit,
                    reference_content=_REF_JOIN.join(items[i][1]),
                )
            )
        refined_outs = gen(
            refine_prompts, owners=[owners[i] for i in refine_idx],
            cache_hints=[template_header(CRITIQUE_REFINE)] * len(refine_idx),
        )
        for i, refined in zip(refine_idx, refined_outs):
            summaries[i] = refined
        return summaries

    def summarize_batch(
        self, docs: list[str], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        gen = _BatchCounter(backend or self.backend, self.max_new_tokens)

        chunks_per_doc = [self.splitter.split_text(d) or [d] for d in docs]
        results = [
            StrategyResult(summary="", num_chunks=len(c)) for c in chunks_per_doc
        ]

        flat = [
            (di, CRITIQUE_MAP.format(content=c))
            for di, chunks in enumerate(chunks_per_doc)
            for c in chunks
        ]
        outs = gen(
            [p for _, p in flat], owners=[di for di, _ in flat],
            cache_hints=[template_header(CRITIQUE_MAP)] * len(flat),
        )
        collapsed: list[list[str]] = [[] for _ in docs]
        for (di, _), out in zip(flat, outs):
            collapsed[di].append(out)

        crit_iters = [0] * len(docs)

        for _ in range(self.max_collapse_rounds):
            pending = [
                di for di, s in enumerate(collapsed)
                if sum(self.count(x) for x in s) > self.token_max
            ]
            if not pending:
                break
            items: list[tuple[list[str], list[str], int]] = []
            owners: list[int] = []
            for di in pending:
                groups = split_by_token_budget(collapsed[di], self.token_max, self.count)
                # positional cursor into the ORIGINAL chunks (ref :279-287)
                cursor = 0
                for g in groups:
                    refs = chunks_per_doc[di][cursor : cursor + len(g)]
                    cursor += len(g)
                    items.append((g, refs or g, crit_iters[di]))
                    owners.append(di)
            outs = self._reduce_with_critique_batch(gen, items, owners)
            for di in pending:
                collapsed[di] = []
            for di, out in zip(owners, outs):
                collapsed[di].append(out)
            for di in pending:
                crit_iters[di] += 1
                results[di].rounds += 1

        # final: build critique context (recursively collapsing intermediates
        # that exceed token_max // 2, ref :305-346), then one last
        # reduce-with-critique per document — each phase batched across docs
        half = self.token_max // 2
        context: list[list[str]] = [list(c) for c in collapsed]
        need_rc = [
            di for di in range(len(docs))
            if sum(self.count(s) for s in collapsed[di]) > half
        ]
        if need_rc:
            items = []
            owners = []
            for di in need_rc:
                for g in split_by_token_budget(collapsed[di], half, self.count):
                    items.append((g, g, crit_iters[di]))
                    owners.append(di)
            outs = self._reduce_with_critique_batch(gen, items, owners)
            for di in need_rc:
                context[di] = []
            for di, out in zip(owners, outs):
                context[di].append(out)

        finals = self._reduce_with_critique_batch(
            gen,
            [(collapsed[di], context[di], crit_iters[di]) for di in range(len(docs))],
            list(range(len(docs))),
        )
        for di, f in enumerate(finals):
            results[di].summary = f
            results[di].llm_calls = gen.calls_by_owner.get(di, 0)
        return results

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]
