"""Truncated strategy: cut the document to the model context and summarize in
one shot (runners/run_summarization_ollama.py:8-37 — tokenize, keep the first
max_context − max_new_tokens tokens, decode back, single prompt).

Copy of ``vnsum_tpu/strategies/truncated.py``. On the one-card engine the
context is the model's; with ``TorchLongContextBackend`` and
``max_context`` set to the long limit it summarizes whole documents.
"""
from __future__ import annotations

from ..backend.base import Backend
from ..text.tokenizer import Tokenizer, get_tokenizer
from .base import StrategyResult, _BatchCounter, register_strategy
from .prompts import TRUNCATED, template_header


@register_strategy
class TruncatedStrategy:
    name = "truncated"

    def __init__(
        self,
        backend: Backend,
        tokenizer: Tokenizer | str = "byte",
        max_context: int = 16384,
        max_new_tokens: int = 1024,
    ) -> None:
        self.backend = backend
        self.tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
        self.max_context = max_context
        self.max_new_tokens = max_new_tokens

    @classmethod
    def from_config(cls, backend: Backend, config, **kw):
        tok = kw.pop("tokenizer", config.tokenizer)
        return cls(
            backend, tokenizer=tok, max_context=config.max_context,
            max_new_tokens=config.max_new_tokens, **kw,
        )

    def _truncate(self, text: str) -> str:
        limit = self.max_context - self.max_new_tokens
        ids = self.tok.encode(text)
        if len(ids) > limit:
            text = self.tok.decode(ids[:limit])
        return text

    def summarize_batch(
        self, docs: list[str], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        gen = _BatchCounter(backend or self.backend, self.max_new_tokens)
        truncated = [self._truncate(d) for d in docs]
        prompts = [TRUNCATED.format(text=t) for t in truncated]
        # the truncated document is the speculation reference (vnsum_tpu_torch.spec);
        # the shared template header is the prefix-cache hint
        outs = gen(
            prompts, owners=list(range(len(docs))), references=truncated,
            cache_hints=[template_header(TRUNCATED)] * len(docs),
        )
        return [
            StrategyResult(summary=o, num_chunks=1, llm_calls=1, rounds=1)
            for o in outs
        ]

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]
