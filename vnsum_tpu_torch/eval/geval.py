"""LLM-judge G-Eval (correctness against the reference, coherence alone).

Copy of ``vnsum_tpu/eval/geval.py``: the reference's DeepEval + OpenRouter
path (evaluate/evaluate_summaries_semantic.py:203-433) without the
deepeval dependency. The judge prompt asks for a 1-5 rating, normalized to
0-1 as G-Eval does; the criteria texts are the reference's, byte for byte
(:275-300). The judge runs over any OpenAI-compatible chat endpoint
(``requests`` is imported inside the call) or a local Backend, and with
``constrained=True`` over ``TorchBackend.score_choices``. Per-case failures
are contained (:318-376), so one bad call never voids a run.
"""
from __future__ import annotations

import json
import re

import numpy as np

from ..core.logging import get_logger

logger = get_logger("vnsum.geval")

CORRECTNESS_CRITERIA = """
        Correctness (1-5): Measures how accurately the generated summary captures the key information and main points from the reference summary.
        Criteria:
        - How much correct information does the generated summary contain compare to the reference summary?
        - Does the generated summay contains contradictions with the source document?
        - How well does the generated summary cover key points and main themes (or events) with respect to the reference?
        """

COHERENCE_CRITERIA = """
        Coherence (1-5): Measures the logical flow, structure, and organization of the generated summary.
        The summary should:
        - Have a clear and logical structure that flows from sentence to sentence
        - Be well-organized with coherent progression of ideas
        - Maintain consistency in style and tone throughout
        - Not be just a collection of random facts, but a cohesive narrative
        - Use appropriate transitions and connections between concepts
        """

_JUDGE_TEMPLATE = """You are an expert evaluator of text summaries.

Evaluation criteria:
{criteria}

{body}

Respond with ONLY a JSON object: {{"score": <number 1-5>, "reason": "<short reason>"}}
"""

_SCORE_RE = re.compile(r'"score"\s*:\s*([0-9.]+)')


def _parse_score(text: str) -> float | None:
    m = _SCORE_RE.search(text)
    if not m:
        m = re.search(r"\b([1-5](?:\.\d+)?)\b", text)
    if not m:
        return None
    raw = float(m.group(1))
    if not 1.0 <= raw <= 5.0:
        return None
    return (raw - 1.0) / 4.0  # normalize 1-5 -> 0-1 like G-Eval


class LLMJudge:
    """Judge over a Backend-protocol generator (local) or an OpenAI-compatible
    HTTP endpoint (set api_base/api_key/model, e.g. OpenRouter)."""

    def __init__(
        self,
        backend=None,
        api_base: str | None = None,
        api_key: str | None = None,
        model: str = "openai/gpt-4o-mini",
        max_new_tokens: int = 256,
        constrained: bool = False,
    ) -> None:
        if backend is None and api_base is None:
            raise ValueError("LLMJudge needs a local backend or an api_base")
        if constrained and not hasattr(backend, "score_choices"):
            raise ValueError(
                "constrained=True needs a backend with score_choices "
                "(TorchBackend's constrained choice scorer)"
            )
        self.backend = backend
        self.api_base = api_base.rstrip("/") if api_base else None
        self.api_key = api_key
        self.model = model
        self.max_new_tokens = max_new_tokens
        # constrained mode: instead of free-decoding the verdict JSON, the
        # judge prompt is extended with the forced prefix `{"score": ` and
        # the engine picks the score digit by next-token logits over
        # {"1".."5"} (TorchBackend.score_choices). The device chooses the
        # score, the host assembles the JSON: a verdict cannot fail to parse
        self.constrained = constrained

    _FORCED_PREFIX = '\n{"score": '

    def _complete(self, prompts: list[str]) -> list[str]:
        if self.backend is not None:
            if self.constrained:
                idx = self.backend.score_choices(
                    [p + self._FORCED_PREFIX for p in prompts],
                    ["1", "2", "3", "4", "5"],
                )
                return [
                    f'{{"score": {i + 1}, '
                    f'"reason": "constrained single-token choice"}}'
                    for i in idx
                ]
            return self.backend.generate(prompts, max_new_tokens=self.max_new_tokens)
        import requests

        outs = []
        for p in prompts:
            resp = requests.post(
                f"{self.api_base}/chat/completions",
                headers={"Authorization": f"Bearer {self.api_key}"},
                json={
                    "model": self.model,
                    "messages": [{"role": "user", "content": p}],
                    "max_tokens": self.max_new_tokens,
                },
                timeout=120,
            )
            resp.raise_for_status()
            outs.append(resp.json()["choices"][0]["message"]["content"])
        return outs

    def evaluate(
        self, generated: dict[str, str], references: dict[str, str]
    ) -> dict:
        """Returns the llm_scores stats block of the results schema."""
        files = sorted(set(generated) & set(references))
        correctness: list[float] = []
        coherence: list[float] = []
        failed = 0
        for fname in files:
            try:
                corr_prompt = _JUDGE_TEMPLATE.format(
                    criteria=CORRECTNESS_CRITERIA,
                    body=(
                        f"Generated summary:\n{generated[fname]}\n\n"
                        f"Reference summary:\n{references[fname]}"
                    ),
                )
                coh_prompt = _JUDGE_TEMPLATE.format(
                    criteria=COHERENCE_CRITERIA,
                    body=f"Generated summary:\n{generated[fname]}",
                )
                corr_out, coh_out = self._complete([corr_prompt, coh_prompt])
                c1, c2 = _parse_score(corr_out), _parse_score(coh_out)
                if c1 is None or c2 is None:
                    raise ValueError("judge returned no parseable score")
                correctness.append(c1)
                coherence.append(c2)
            except Exception as e:  # per-case containment (ref :373-376)
                failed += 1
                logger.warning("G-Eval failed for %s: %s", fname, e)

        def _stats(prefix: str, vals: list[float]) -> dict:
            if not vals:
                return {f"{prefix}_mean": 0.0, f"{prefix}_std": 0.0,
                        f"{prefix}_min": 0.0, f"{prefix}_max": 0.0}
            return {
                f"{prefix}_mean": float(np.mean(vals)),
                f"{prefix}_std": float(np.std(vals)),
                f"{prefix}_min": float(np.min(vals)),
                f"{prefix}_max": float(np.max(vals)),
            }

        return {
            **_stats("llm_correctness", correctness),
            **_stats("llm_coherence", coherence),
            "llm_successful_cases": len(correctness),
            "llm_failed_cases": failed,
            "llm_total_cases_processed": len(files),
        }
