"""Strategy layer scaffolding (copy of ``vnsum_tpu/strategies/base.py``).

A strategy is a plain driver object: host-side Python owns the
data-dependent control flow (collapse-until-fits), and every round's LLM
calls go to the backend as ONE batch, across chunks and across documents.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol

from ..backend.base import Backend
from ..text.tokenizer import whitespace_token_count


@dataclass
class StrategyResult:
    summary: str
    num_chunks: int = 1
    llm_calls: int = 0
    rounds: int = 0
    meta: dict = field(default_factory=dict)


class Strategy(Protocol):
    """A strategy instance holds only configuration; every run's mutable
    state is local to the summarize_batch call."""

    name: str

    def summarize_batch(self, docs: list[str]) -> list[StrategyResult]: ...

    def summarize(self, doc: str) -> StrategyResult: ...


class _BatchCounter:
    """Wraps backend.generate to count calls for StrategyResult accounting.

    Every prompt of a shared batch belongs to exactly one document — callers
    pass ``owners`` (one doc index per prompt) so `calls_by_owner` carries
    true per-document llm_calls (run_full_evaluation_pipeline.py:575-582)."""

    def __init__(self, backend: Backend, max_new_tokens: int | None = None):
        self.backend = backend
        self.max_new_tokens = max_new_tokens
        self.calls_by_owner: dict[int, int] = {}

    def __call__(
        self,
        prompts: list[str],
        owners: list[int],
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list[str]:
        """``references`` optionally aligns one source text per prompt: the
        seam reference-guided speculative decoding rides (strategies pass
        the text being summarized). ``cache_hints`` aligns one
        expected-to-recur prompt PREFIX per prompt: the prefix KV cache's
        seam (strategies pass their template header). Backends without
        either feature ignore them."""
        if not prompts:
            return []
        if len(owners) != len(prompts):
            raise ValueError("owners must tag every prompt")
        if references is not None and len(references) != len(prompts):
            raise ValueError("references must align with prompts")
        if cache_hints is not None and len(cache_hints) != len(prompts):
            raise ValueError("cache_hints must align with prompts")
        for o in owners:
            self.calls_by_owner[o] = self.calls_by_owner.get(o, 0) + 1
        # keep the plain call shape for backends (and test doubles) without
        # the advisory keywords: pass each only when it carries data
        kw = {}
        if references is not None and any(references):
            kw["references"] = references
        if cache_hints is not None and any(cache_hints):
            kw["cache_hints"] = cache_hints
        return self.backend.generate(prompts, max_new_tokens=self.max_new_tokens, **kw)


def split_by_token_budget(
    texts: list[str],
    budget: int,
    count: Callable[[str], int] = whitespace_token_count,
) -> list[list[str]]:
    """Greedy grouping: consecutive texts accumulate until adding one would
    exceed ``budget`` (langchain split_list_of_docs semantics used by the
    reference collapse, runners/..._mapreduce.py:130-137). A single oversized
    text forms its own group."""
    groups: list[list[str]] = []
    cur: list[str] = []
    cur_total = 0
    for t in texts:
        n = count(t)
        if cur and cur_total + n > budget:
            groups.append(cur)
            cur, cur_total = [], 0
        cur.append(t)
        cur_total += n
    if cur:
        groups.append(cur)
    return groups


STRATEGY_REGISTRY: dict[str, type] = {}


def register_strategy(cls):
    STRATEGY_REGISTRY[cls.name] = cls
    return cls


def get_strategy(name: str, backend: Backend, config, **kw):
    """Instantiate a strategy from PipelineConfig-style settings."""
    if name not in STRATEGY_REGISTRY:
        raise ValueError(
            f"unknown strategy {name!r}; have {sorted(STRATEGY_REGISTRY)}"
        )
    return STRATEGY_REGISTRY[name].from_config(backend, config, **kw)
