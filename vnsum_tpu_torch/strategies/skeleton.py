"""Skeleton-of-Thought strategy (arXiv 2307.15337; copy of
``vnsum_tpu/strategies/skeleton.py``).

SoT decodes an answer in two stages: a short OUTLINE call produces a
numbered skeleton of the answer, then every skeleton point is expanded in
parallel and the expansions are stitched back in point order. The outline
is one round, the expansions one fan-out round over every point of every
document (all sharing the SKELETON_EXPAND template header as their
prefix-cache hint), and the stitch is a pure ordered join — no final LLM
call.

The document is truncated to the model context first (same contract as
TruncatedStrategy: SoT trades the map-reduce strategies' full-document
coverage for intra-request parallelism on what fits). Over a backend with
the serving layer's ``submit_round``/``harvest`` pair a document's
expansions launch as soon as its own outline lands
(``_summarize_batch_streaming``).
"""
from __future__ import annotations

import re

from ..backend.base import Backend
from ..text.tokenizer import Tokenizer, get_tokenizer
from .base import StrategyResult, _BatchCounter, register_strategy
from .prompts import SKELETON_EXPAND, SKELETON_OUTLINE, template_header

# "1. điểm", "2) điểm", with leading whitespace tolerated
_POINT_RE = re.compile(r"^\s*\d+[.)]\s*(.+?)\s*$")


@register_strategy
class SkeletonStrategy:
    name = "skeleton"

    def __init__(
        self,
        backend: Backend,
        tokenizer: Tokenizer | str = "byte",
        max_context: int = 16384,
        max_new_tokens: int = 1024,
        max_points: int = 8,
    ) -> None:
        self.backend = backend
        self.tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
        self.max_context = max_context
        self.max_new_tokens = max_new_tokens
        # the outline prompt asks for 3-8 points; the parser enforces the
        # ceiling so a rambling outline can't fan out unboundedly
        self.max_points = max_points

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

    def _parse_points(self, outline: str) -> list[str]:
        """Numbered lines of the skeleton, in order. A model that ignored
        the numbering contract degrades to a single point (the whole
        outline text) — one expansion, never a lost document."""
        points = [
            m.group(1)
            for line in outline.splitlines()
            if (m := _POINT_RE.match(line))
        ]
        if not points:
            stripped = outline.strip()
            points = [stripped] if stripped else ["Tóm tắt nội dung chính."]
        return points[: self.max_points]

    def summarize_batch(
        self, docs: list[str], *, backend: Backend | None = None
    ) -> list[StrategyResult]:
        be = backend or self.backend
        if callable(getattr(be, "submit_round", None)) and callable(
            getattr(be, "harvest", None)
        ):
            return self._summarize_batch_streaming(docs, be)
        gen = _BatchCounter(be, self.max_new_tokens)
        truncated = [self._truncate(d) for d in docs]

        outlines = gen(
            [SKELETON_OUTLINE.format(content=t) for t in truncated],
            owners=list(range(len(docs))),
            references=truncated,
            cache_hints=[template_header(SKELETON_OUTLINE)] * len(docs),
        )
        points_per = [self._parse_points(o) for o in outlines]

        # expand: every point of every document in ONE batch; the document
        # rides along as the speculation reference (expansions are largely
        # extractive) and the shared expand header is the cache hint
        flat = [
            (di, SKELETON_EXPAND.format(point=p, content=truncated[di]))
            for di, points in enumerate(points_per)
            for p in points
        ]
        outs = gen(
            [p for _, p in flat],
            owners=[di for di, _ in flat],
            references=[truncated[di] for di, _ in flat],
            cache_hints=[template_header(SKELETON_EXPAND)] * len(flat),
        )
        per_doc: list[list[str]] = [[] for _ in docs]
        for (di, _), out in zip(flat, outs):
            per_doc[di].append(out)

        return [
            StrategyResult(
                summary="\n\n".join(per_doc[di]),
                num_chunks=len(points_per[di]),
                llm_calls=gen.calls_by_owner.get(di, 0),
                rounds=2,
                meta={"points": len(points_per[di])},
            )
            for di in range(len(docs))
        ]

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]

    def _summarize_batch_streaming(
        self, docs: list[str], be: Backend
    ) -> list[StrategyResult]:
        """Streaming SoT over a submit_round/harvest backend: a document's
        expansion fan-out launches the moment ITS outline lands,
        overlapping other documents' still-running outlines, and the stitch
        is an ordered join as expansions complete. An EXPANSION failing
        typed POISON is dropped from the stitch (the gang is marked partial
        so the parent aggregate reports a degraded summary); an outline
        failure still fails the call — there is no skeleton to degrade to."""
        from concurrent.futures import FIRST_COMPLETED, wait

        truncated = [self._truncate(d) for d in docs]
        results = [StrategyResult(summary="") for _ in docs]
        calls = [0] * len(docs)
        pending: dict = {}  # future -> ("outline"|"expand", di, pi)
        expansions: list[list[str | None]] = [[] for _ in docs]
        expands_left = [0] * len(docs)
        points_per: list[list[str]] = [[] for _ in docs]

        futs = be.submit_round(
            [SKELETON_OUTLINE.format(content=t) for t in truncated],
            phase="outline",
            max_new_tokens=self.max_new_tokens,
            references=truncated,
            cache_hints=[template_header(SKELETON_OUTLINE)] * len(docs),
        )
        for di, fut in enumerate(futs):
            pending[fut] = ("outline", di, 0)
            calls[di] += 1

        while pending:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                kind, di, pi = pending.pop(fut)
                out = be.harvest(fut, tolerate_poison=(kind == "expand"))
                if kind == "outline":
                    points = self._parse_points(out)
                    points_per[di] = points
                    expansions[di] = [None] * len(points)
                    expands_left[di] = len(points)
                    efuts = be.submit_round(
                        [
                            SKELETON_EXPAND.format(
                                point=p, content=truncated[di])
                            for p in points
                        ],
                        phase="expand",
                        max_new_tokens=self.max_new_tokens,
                        references=[truncated[di]] * len(points),
                        cache_hints=[template_header(SKELETON_EXPAND)]
                        * len(points),
                    )
                    for epi, efut in enumerate(efuts):
                        pending[efut] = ("expand", di, epi)
                        calls[di] += 1
                    continue
                if out is None:
                    results[di].meta["dropped_points"] = (
                        results[di].meta.get("dropped_points", 0) + 1
                    )
                else:
                    expansions[di][pi] = out
                expands_left[di] -= 1
                if expands_left[di] == 0:
                    results[di].summary = "\n\n".join(
                        e for e in expansions[di] if e is not None
                    )

        for di, r in enumerate(results):
            r.num_chunks = len(points_per[di])
            r.llm_calls = calls[di]
            r.rounds = 2
            r.meta["points"] = len(points_per[di])
        return results

    def summarize(self, doc: str, *, backend: Backend | None = None) -> StrategyResult:
        return self.summarize_batch([doc], backend=backend)[0]
