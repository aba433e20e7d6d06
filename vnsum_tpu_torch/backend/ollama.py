"""Ollama HTTP backend, a local server behind the Backend protocol.

Copy of ``vnsum_tpu/backend/ollama.py``: the reference's OllamaLLM
(runners/run_summarization_ollama_mapreduce.py:37-60) with its drifted
copies' fixes folded in (``think: false``, the 600 s read timeout,
thinking-token cleaning), a (connect, read) timeout pair, jittered retries
of the failures ``transient`` accepts (the JAX copy also lists their
classes, which ``transient`` alone decides here), and batches run over a
thread pool. ``requests`` is imported inside each call, so the module
imports where it is not installed.
"""
from __future__ import annotations

import json

from concurrent.futures import ThreadPoolExecutor

from ..core.config import GenerationConfig

from .base import resolve_max_new
from ..core.faults import call_with_retries
from ..core.logging import get_logger
from ..text.cleaning import clean_thinking_tokens
from ..text.tokenizer import whitespace_token_count

logger = get_logger("vnsum.backend.ollama")


class OllamaBackend:
    name = "ollama"

    def __init__(
        self,
        model: str = "llama3.2:3b",
        url: str = "http://localhost:11434",
        max_new_tokens: int = 1024,
        timeout: float = 600.0,
        connect_timeout: float = 5.0,
        clean_output: bool = True,
        concurrency: int = 4,
        max_retries: int = 3,
        retry_backoff: float = 1.0,
        retry_jitter: float = 0.25,
    ) -> None:
        self.model = model
        self.url = url.rstrip("/")
        self.max_new_tokens = max_new_tokens
        # split (connect, read) timeouts: a dead host fails in seconds at
        # the TCP handshake instead of burning the 600 s READ budget a slow
        # generation legitimately needs — requests accepts the tuple form
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self.clean_output = clean_output
        self.concurrency = concurrency
        self.max_retries = max(0, max_retries)
        self.retry_backoff = retry_backoff
        # jittered backoff: this backend fans prompts over a thread pool,
        # and unjittered retries from `concurrency` workers re-slam a
        # recovering server in lockstep
        self.retry_jitter = retry_jitter

    @property
    def _timeouts(self) -> tuple[float, float]:
        return (self.connect_timeout, self.timeout)

    def health_check(self) -> list[str]:
        """GET /api/tags; returns available model names
        (ref run_full_evaluation_pipeline.py:199-233)."""
        import requests

        resp = requests.get(
            f"{self.url}/api/tags", timeout=(self.connect_timeout, 10)
        )
        resp.raise_for_status()
        return [m["name"] for m in resp.json().get("models", [])]

    def _one(self, prompt: str, max_new: int, config: GenerationConfig | None) -> str:
        import requests

        options: dict = {"num_predict": max_new}
        if config is not None:
            options["temperature"] = config.temperature
            if config.top_k > 0:
                options["top_k"] = config.top_k
            if config.top_p < 1.0:
                options["top_p"] = config.top_p
            if config.seed:
                options["seed"] = config.seed
        payload = {
            "model": self.model,
            "prompt": prompt,
            "stream": False,
            "think": False,
            "options": options,
        }
        def attempt() -> str:
            resp = requests.post(
                f"{self.url}/api/generate", json=payload,
                timeout=self._timeouts,
            )
            resp.raise_for_status()
            text = resp.json()["response"]
            return clean_thinking_tokens(text) if self.clean_output else text

        # requests' JSONDecodeError does NOT subclass json.JSONDecodeError
        # when simplejson is installed (it is here), so catch both; getattr
        # keeps test doubles that stub out `requests` working
        json_errors = (
            getattr(
                getattr(requests, "exceptions", None),
                "JSONDecodeError",
                json.JSONDecodeError,
            ),
            json.JSONDecodeError,
        )

        def transient(e: Exception) -> bool:
            # ConnectionError yes; NOT requests.Timeout (with the 600 s read
            # timeout a hung server would stall ~40 min/prompt across
            # retries); HTTP 5xx, 429 (load shed), 408 (request timeout);
            # a truncated/garbled 200 body (JSONDecodeError, or KeyError for
            # a body missing "response") is also a server-side transient.
            # NOT plain ValueError: MissingSchema/InvalidURL subclass it and
            # are unfixable config errors that must fail fast.
            if isinstance(e, requests.HTTPError):
                status = e.response.status_code if e.response is not None else 0
                return status >= 500 or status in (408, 429)
            return isinstance(
                e, (requests.ConnectionError, *json_errors, KeyError)
            )

        # the reference has no retries anywhere (SURVEY.md §5 "Failure
        # detection"), so one dropped connection voids a whole document there
        return call_with_retries(
            attempt,
            max_retries=self.max_retries,
            backoff=self.retry_backoff,
            jitter=self.retry_jitter,
            should_retry=transient,
            what="ollama call",
        )

    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,  # spec metadata; unused
        cache_hints: list[str | None] | None = None,  # cache metadata; unused
    ) -> list[str]:
        max_new = resolve_max_new(max_new_tokens, config, self.max_new_tokens)
        if len(prompts) == 1:
            return [self._one(prompts[0], max_new, config)]
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            return list(pool.map(lambda p: self._one(p, max_new, config), prompts))

    def count_tokens(self, text: str) -> int:
        """Whitespace estimate, matching OllamaLLM.get_num_tokens
        (...mapreduce.py:58-60) for collapse-gating parity."""
        return whitespace_token_count(text)

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        return [whitespace_token_count(t) for t in texts]
