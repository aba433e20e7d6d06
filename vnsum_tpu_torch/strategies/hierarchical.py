"""Hierarchical tree-collapse strategy (copy of the batch path of
``vnsum_tpu/strategies/hierarchical.py``).

Semantics follow runners/run_summarization_ollama_mapreduce_hierarchical.py:
bottom-up over the document structure tree — for depth target..1, every
non-Paragraph node's descendant paragraph text is map-reduce summarized
(title-prefixed) and the node mutates into a Paragraph leaf (:242-315); then
one final map-reduce over the remaining paragraphs and a grammar/flow polish
pass. Chunk sizes are clamped to 75% of the model context (:178-179).

The reference's per-node mini map-reduce is a sequential loop (:125-154);
here every node at a level maps its chunks in one backend batch, and the
per-node reduces batch as well. (The JAX package's streaming path for the
serving layer is not ported.)
"""
from __future__ import annotations

from ..backend.base import Backend
from ..text.splitter import RecursiveTokenSplitter
from ..text.tree import (
    Node,
    collect_nodes_at_depth,
    extract_descendant_paragraph_text,
    replace_node_with_paragraph,
    tree_depth,
)
from .base import StrategyResult, _BatchCounter, register_strategy
from .prompts import (
    HIERARCHICAL_MAP,
    HIERARCHICAL_POLISH,
    HIERARCHICAL_REDUCE,
    template_header,
)


@register_strategy
class HierarchicalStrategy:
    name = "mapreduce_hierarchical"

    def __init__(
        self,
        backend: Backend,
        chunk_size: int = 12000,
        chunk_overlap: int = 200,
        max_depth: int = 1,
        max_context: int = 16384,
        max_new_tokens: int | None = None,
    ) -> None:
        self.backend = backend
        # 75%-of-context safety clamp (ref :178-179)
        self.chunk_size = min(chunk_size, int(max_context * 0.75))
        self.chunk_overlap = chunk_overlap
        self.max_depth = max_depth
        self.max_new_tokens = max_new_tokens
        self.splitter = RecursiveTokenSplitter(
            self.chunk_size, chunk_overlap,
            length_function=backend.count_tokens,
            length_batch_function=getattr(backend, "count_tokens_batch", None),
        )

    @classmethod
    def from_config(cls, backend: Backend, config, **kw):
        return cls(
            backend,
            chunk_size=config.chunk_size,
            chunk_overlap=config.chunk_overlap,
            max_depth=config.max_depth,
            max_context=config.max_context,
            max_new_tokens=config.max_new_tokens,
            **kw,
        )

    def _mapreduce_texts_batch(
        self, gen: _BatchCounter, texts: list[str], owners: list[int]
    ) -> tuple[list[str], list[int]]:
        """Mini map-reduce over several independent texts: map all chunks of
        all texts in one batch, then one reduce per text (single round, like
        the reference's simple graph :125-154). ``owners`` maps each text to
        its tree for per-doc call accounting. Returns (summaries, per-text
        chunk counts)."""
        chunks_per = [self.splitter.split_text(t) or [t] for t in texts]
        flat = [
            (ti, HIERARCHICAL_MAP.format(content=c))
            for ti, chunks in enumerate(chunks_per)
            for c in chunks
        ]
        outs = gen(
            [p for _, p in flat], owners=[owners[ti] for ti, _ in flat],
            cache_hints=[template_header(HIERARCHICAL_MAP)] * len(flat),
        )
        per_text: list[list[str]] = [[] for _ in texts]
        for (ti, _), out in zip(flat, outs):
            per_text[ti].append(out)
        reduces = gen(
            [HIERARCHICAL_REDUCE.format(docs="\n\n".join(s)) for s in per_text],
            owners=owners,
            cache_hints=[template_header(HIERARCHICAL_REDUCE)] * len(per_text),
        )
        return reduces, [len(c) for c in chunks_per]

    def summarize_tree_batch(
        self, roots: list[Node], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        gen = _BatchCounter(backend or self.backend, self.max_new_tokens)
        results = [StrategyResult(summary="") for _ in roots]
        targets = [min(self.max_depth, tree_depth(r)) for r in roots]
        total_chunks = [0] * len(roots)

        # lockstep bottom-up collapse: one backend round per depth level,
        # shared across trees (trees deeper than others just join later)
        for depth in range(max(targets, default=0), 0, -1):
            nodes: list[Node] = []
            owners: list[int] = []
            texts: list[str] = []
            for ri, root in enumerate(roots):
                if depth > targets[ri]:
                    continue
                for node in collect_nodes_at_depth(root, depth):
                    body = extract_descendant_paragraph_text(node)
                    if not body.strip():
                        continue
                    title = node.get("text", "") or ""
                    nodes.append(node)
                    owners.append(ri)
                    texts.append(f"{title}:\n{body}" if title else body)
            if not texts:
                continue
            summaries, chunk_counts = self._mapreduce_texts_batch(gen, texts, owners)
            for ri, node, summary, n in zip(owners, nodes, summaries, chunk_counts):
                title = node.get("text", "") or ""
                replace_node_with_paragraph(
                    node, f"{title}:\n{summary}" if title else summary
                )
                total_chunks[ri] += n
            for ri in set(owners):
                results[ri].rounds += 1

        final_texts = [extract_descendant_paragraph_text(r) for r in roots]
        all_ris = list(range(len(roots)))
        finals, final_counts = self._mapreduce_texts_batch(gen, final_texts, all_ris)
        polished = gen(
            [HIERARCHICAL_POLISH.format(summary=f) for f in finals], owners=all_ris,
            cache_hints=[template_header(HIERARCHICAL_POLISH)] * len(finals),
        )
        for ri, p in enumerate(polished):
            results[ri].summary = p
            results[ri].num_chunks = max(total_chunks[ri] + final_counts[ri], 1)
            results[ri].llm_calls = gen.calls_by_owner.get(ri, 0)
        return results

    # plain-text entry: treat the whole document as a single Document node
    def summarize_batch(
        self, docs: list[str], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        roots = [
            {
                "type": "Document",
                "text": "",
                "children": [{"type": "Paragraph", "text": d}],
            }
            for d in docs
        ]
        return self.summarize_tree_batch(roots, backend=backend)

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]
