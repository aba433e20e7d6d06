"""Deterministic fake backend for hermetic strategy and judge tests.

Copy of ``vnsum_tpu/backend/fake.py`` for what the port runs. Two modes:

- extractive (default): return the first ``summary_words`` words of the
  longest <content>-like region of the prompt, so collapse loops terminate
  the way real summarization does;
- scripted: pop canned responses in order (critique accept-paths, judge
  verdicts).

An optional latency model (``batch_overhead_s`` + ``per_token_s`` per
uncached prompt word, ``per_prompt_s`` a row, ``per_step_s`` a decode step
of the longest row, the per-row terms divided over ``dp_replicas``) makes a
generate() call sleep like a device dispatch; it defaults off.
``batch_sizes`` records the prompt count of each call, ``calls`` the
prompts, ``references_seen`` and ``cache_hints_seen`` the per-prompt
metadata.

Speculative decoding is mirrored synthetically: with ``config.spec_k`` (or
the constructor's ``spec_k``) > 0 each prompt gets a deterministic
SpecRecord at the ``spec_acceptance`` rate, retrievable once through
``take_spec_report()``, the contract TorchBackend exposes.

The prefix KV cache (``vnsum_tpu_torch.cache``) is mirrored the same way:
``prefix_cache_blocks > 0`` runs the port's radix index (cache/radix.py)
over whitespace words (block matching, ref-counted pins, LRU eviction) with
no device pool behind it. ``cache_hints`` bound insertion as in the
engine, hit counts flow through ``take_cache_report()``,
``cached_prefix_tokens()`` and ``prefix_cache_stats()``, and
``per_token_s`` bills only uncached words.

Not ported yet, and refused when asked for: the serving hooks (the slot
loop, cancel and drain, ROADMAP A15).
"""
from __future__ import annotations

import re
import time

from ..cache.radix import RadixIndex
from ..core.config import GenerationConfig
from ..spec import SpecRecord
from ..text.tokenizer import whitespace_token_count

_BLOCK = re.compile(
    r"<(?:content|summary|docs|reference_content|critique)>\n?(.*?)\n?</(?:content|summary|docs|reference_content|critique)>",
    re.DOTALL,
)


class FakeBackend:
    name = "fake"

    def __init__(
        self,
        responses: list[str] | None = None,
        summary_words: int = 40,
        prefix: str = "",
        batch_overhead_s: float = 0.0,
        per_prompt_s: float = 0.0,
        per_token_s: float = 0.0,
        spec_k: int = 0,
        spec_acceptance: float = 0.5,
        prefix_cache_blocks: int = 0,
        cache_block_tokens: int = 8,
        per_step_s: float = 0.0,
        dp_replicas: int = 1,
    ) -> None:
        self._responses = list(responses) if responses else None
        self.summary_words = summary_words
        self.prefix = prefix
        self.batch_overhead_s = batch_overhead_s
        self.per_prompt_s = per_prompt_s
        self.per_token_s = per_token_s
        # the spec_k applied when a call's config carries none
        self.spec_k = spec_k
        self.spec_acceptance = spec_acceptance
        # a one-shot batch decodes until its longest row finishes
        self.per_step_s = per_step_s
        # per-row costs divide over data-parallel replicas, per-dispatch and
        # per-step costs do not
        self.dp_replicas = max(int(dp_replicas), 1)
        # the prefix cache's mirror: the radix index over whitespace words
        # (tokens here are words, as count_tokens counts them)
        self.prefix_index = None
        if prefix_cache_blocks:
            self.prefix_index = RadixIndex(prefix_cache_blocks, cache_block_tokens)
        # False stops index insertion while hits keep serving, as
        # TorchBackend.set_prefix_cache_inserts
        self.cache_inserts_enabled = True
        self.calls: list[str] = []
        self.batch_sizes: list[int] = []
        self.references_seen: list[str | None] = []
        self.cache_hints_seen: list[str | None] = []
        self._spec_report: list[SpecRecord] = []
        self._cache_report: list[int] = []

    def _one(self, prompt: str) -> str:
        if self._responses is not None:
            if not self._responses:
                raise RuntimeError("FakeBackend ran out of scripted responses")
            return self._responses.pop(0)
        blocks = _BLOCK.findall(prompt)
        source = max(blocks, key=len) if blocks else prompt
        words = source.split()
        return self.prefix + " ".join(words[: self.summary_words])

    def _cache_pass(self, prompts: list[str], cache_hints: list[str | None] | None) -> int:
        """Match then insert, in the engine's per-call order: ALL prompts
        match up front (pinned), insertion follows, so duplicates within
        one call miss together as in one engine batch. Returns the total
        UNCACHED words for the latency model; fills ``_cache_report`` with
        per-prompt hit counts."""
        idx = self.prefix_index
        words_per = [p.split() for p in prompts]
        matches = [idx.match(w, max_tokens=len(w) - 1) for w in words_per]
        # pins released on every path: a leaked pin would make its blocks
        # unevictable for good
        try:
            if self.cache_inserts_enabled:
                for i, w in enumerate(words_per):
                    hint = cache_hints[i] if cache_hints else None
                    if hint:
                        # the engine's _hint_prefix_len: the hint bounds
                        # insertion to its common prefix with the prompt
                        hw = hint.split()
                        upto = 0
                        while upto < min(len(hw), len(w)) and hw[upto] == w[upto]:
                            upto += 1
                    else:
                        upto = len(w) - 1
                    idx.insert(w, min(upto, len(w) - 1))
        finally:
            for m in matches:
                idx.release(m)
        self._cache_report = [m.tokens for m in matches]
        return sum(len(w) - m.tokens for w, m in zip(words_per, matches))

    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list[str]:
        self.calls.extend(prompts)
        self.batch_sizes.append(len(prompts))
        self.references_seen.extend(
            references if references is not None else [None] * len(prompts)
        )
        self.cache_hints_seen.extend(
            cache_hints if cache_hints is not None else [None] * len(prompts)
        )
        if self.prefix_index is not None:
            uncached = self._cache_pass(prompts, cache_hints)
        else:
            uncached = sum(len(p.split()) for p in prompts)
            self._cache_report = []
        outs_early = None
        rep = self.dp_replicas
        prefill_s = self.batch_overhead_s + self.per_token_s * -(-uncached // rep)
        decode_s = self.per_prompt_s * -(-len(prompts) // rep)
        if self.per_step_s:
            # every row of the batch pays for its longest row's steps
            outs_early = [self._one(p) for p in prompts]
            decode_s += self.per_step_s * max(
                (len(o.split()) for o in outs_early), default=0
            )
        if prefill_s or decode_s:
            time.sleep(prefill_s + decode_s)
        outs = (
            outs_early if outs_early is not None
            else [self._one(p) for p in prompts]
        )
        k = config.spec_k if config is not None else self.spec_k
        self._spec_report = [
            self._synthetic_spec(k, references[i] if references else None, o)
            for i, o in enumerate(outs)
        ] if k > 0 else []
        return outs

    def _synthetic_spec(self, k: int, reference, out: str) -> SpecRecord:
        """Deterministic per-prompt stats: a row with a reference drafts k
        per step and keeps spec_acceptance of them; one with no reference
        drafts nothing (matching the real drafter's degradation)."""
        steps = max(len(out.split()), 1)
        drafted = k * steps if reference else 0
        return SpecRecord(
            draft_tokens=drafted,
            accepted_tokens=int(drafted * self.spec_acceptance),
            verify_steps=steps,
        )

    def take_spec_report(self) -> list[SpecRecord]:
        """Per-prompt SpecRecords of the last generate call (empty when
        speculation was off), cleared on read."""
        report, self._spec_report = self._spec_report, []
        return report

    def take_cache_report(self) -> list[int]:
        """Per-prompt prefix-cache hit words of the last generate call
        (empty when the cache is off), cleared on read."""
        report, self._cache_report = self._cache_report, []
        return report

    def set_prefix_cache_inserts(self, enabled: bool) -> None:
        """Gate index insertion (hits still serve)."""
        self.cache_inserts_enabled = bool(enabled)

    def cached_prefix_tokens(self, text: str, cache_hint: str | None = None) -> int:
        """Read-only probe in whitespace words (as count_tokens counts)."""
        if self.prefix_index is None:
            return 0
        words = text.split()
        return self.prefix_index.probe(words, max_tokens=len(words) - 1)

    def prefix_cache_stats(self) -> dict | None:
        if self.prefix_index is None:
            return None
        return self.prefix_index.stats_dict()

    def count_tokens(self, text: str) -> int:
        return whitespace_token_count(text)

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        return [whitespace_token_count(t) for t in texts]

    # -- serving hooks (ROADMAP A15) ----------------------------------------

    def start_slot_loop(self, *args, **kwargs):
        raise NotImplementedError(
            "FakeBackend's slot loop (FakeSlotLoop) is not ported yet (ROADMAP A15)")

    def set_cancel_poll(self, poll) -> None:
        raise NotImplementedError(
            "FakeBackend's cancel hook is not ported yet (ROADMAP A15)")

    def request_drain(self) -> None:
        raise NotImplementedError(
            "FakeBackend's drain hook is not ported yet (ROADMAP A15)")
