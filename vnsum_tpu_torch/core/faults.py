"""Retry policy for the pipeline's document batches.

Copy of ``call_with_retries`` and the retry predicate of
``vnsum_tpu/core/faults.py`` (the pipeline's batch retry and the Ollama
backend's per-request retry), with one change: by default a
``RuntimeError`` is never retried here. PyTorch reports device faults (a
failed kernel launch, an illegal address, out of memory) as
``RuntimeError`` or subclasses of it; a retry cannot fix them, and a
silent retry would hide a kernel fault.
"""
from __future__ import annotations

import json
import random
import time

from .logging import get_logger

logger = get_logger("vnsum.faults")

# error classes a retry can never fix
PERMANENT_ERRORS = (
    FileNotFoundError, TypeError, ValueError, KeyError, AttributeError,
    IndexError, NotImplementedError, RuntimeError,
)


def is_retryable(e: BaseException) -> bool:
    """Fail fast on PERMANENT_ERRORS, except json.JSONDecodeError (a
    garbled-body transient that subclasses ValueError)."""
    return isinstance(e, json.JSONDecodeError) or not isinstance(
        e, PERMANENT_ERRORS
    )


def call_with_retries(
    fn,
    *,
    max_retries: int,
    backoff: float = 1.0,
    max_backoff: float = 60.0,
    jitter: float = 0.0,
    should_retry=is_retryable,
    what: str = "call",
):
    """Run fn(); on a failure that ``should_retry`` accepts, wait
    min(backoff * 2^attempt, max_backoff) * (1 + jitter * U[0,1)) and rerun,
    up to max_retries extra attempts. ``jitter`` desynchronizes concurrent
    retriers. Re-raises the last failure, or at once a non-retryable one."""
    max_retries = max(max_retries, 0)
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except Exception as e:
            if not should_retry(e) or attempt >= max_retries:
                raise
            delay = min(backoff * (2 ** attempt), max_backoff)
            if jitter:
                delay *= 1.0 + jitter * random.random()
            logger.warning(
                "%s failed (%s: %s); retry %d/%d in %.1fs",
                what, type(e).__name__, e, attempt + 1, max_retries, delay,
            )
            time.sleep(delay)
