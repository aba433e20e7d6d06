"""Model-output sanitization.

Behavioral parity with the reference's clean_thinking_tokens
(run_full_evaluation_pipeline.py:34-63; duplicated with drift at
runners/..._critique.py:26-46, ..._iterative.py:19-47, ..._hierarchical.py:20-40).
This is the single canonical copy; the hierarchical variant's
collapse-all-whitespace behavior (:39) is available via `collapse_whitespace=True`.
"""
from __future__ import annotations

import re

_TAG_PATTERNS = [
    re.compile(r"<think>.*?</think>", re.DOTALL | re.IGNORECASE),
    re.compile(r"<thinking>.*?</thinking>", re.DOTALL | re.IGNORECASE),
    re.compile(r"<thought>.*?</thought>", re.DOTALL | re.IGNORECASE),
    re.compile(r"<reasoning>.*?</reasoning>", re.DOTALL | re.IGNORECASE),
    re.compile(r"<analysis>.*?</analysis>", re.DOTALL | re.IGNORECASE),
]
_TRIPLE_NEWLINE = re.compile(r"\n\s*\n\s*\n")
_ALL_WS = re.compile(r"\s+")


def clean_thinking_tokens(text: str, *, collapse_whitespace: bool = False) -> str:
    """Strip <think>/<thinking>/<thought>/<reasoning>/<analysis> blocks and
    normalize leftover whitespace."""
    if not text:
        return text
    cleaned = text
    for pat in _TAG_PATTERNS:
        cleaned = pat.sub("", cleaned)
    if collapse_whitespace:
        cleaned = _ALL_WS.sub(" ", cleaned)
    else:
        cleaned = _TRIPLE_NEWLINE.sub("\n\n", cleaned)
    return cleaned.strip()
