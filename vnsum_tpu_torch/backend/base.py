"""The Backend protocol and the shared device-batch helpers.

Copy of ``vnsum_tpu/backend/base.py``: ONE batched interface — ``generate``
takes a list of prompts so strategies submit every LLM call of a round as
one unit — plus the packing, seed, stop-token and sampling-vocabulary rules
the engine's greedy parity with the JAX package depends on.
``mask_unsampleable`` is written for torch tensors.

Optional prefix-cache contract (``vnsum_tpu_torch.cache``): a backend with
a prefix KV cache also exposes ``cached_prefix_tokens(text,
cache_hint=None)`` (a read-only probe, safe from other threads: how many of
a prompt's tokens the cache would serve), ``take_cache_report()``
(per-prompt cached token counts of the last generate, cleared on read) and
``prefix_cache_stats()`` (pool and index counters; None with the cache
off). Callers find them through getattr, so plain backends need none.
TorchBackend implements the real thing; FakeBackend mirrors it (the radix
index over whitespace words, no device pool).
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..core.config import GenerationConfig
from ..core.logging import get_logger


@runtime_checkable
class Backend(Protocol):
    name: str

    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list[str]:
        """Generate one completion per prompt, order-preserving.
        ``references`` (speculation sources) and ``cache_hints`` (recurring
        prompt prefixes) align one entry per prompt and are advisory."""
        ...

    def count_tokens(self, text: str) -> int:
        ...

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        """Batched count — the splitter issues one call per split level
        instead of one per sentence piece."""
        ...


def fold_seed(gen_seed: int, backend_seed: int, dispatch: int) -> int:
    """Per-batch seed folded from (config seed, backend seed, dispatch
    index): sampled batches draw fresh randomness, same-seed reruns over the
    same call sequence replay exactly, greedy ignores it."""
    return (
        gen_seed * 0x9E3779B1 + backend_seed * 0x85EBCA77 + dispatch
    ) & 0x7FFFFFFF


def left_pad_batch(encoded_group, B: int, S: int, pad_id: int):
    """Pack encoded prompts into a fixed-shape left-padded [B, S] batch;
    rows beyond the group are all-pad filler. Returns (tokens, pad_lens)."""
    tokens = np.full((B, S), pad_id, dtype=np.int32)
    pad_lens = np.full((B,), S, dtype=np.int32)
    for row, ids in enumerate(encoded_group):
        tokens[row, S - len(ids):] = ids
        pad_lens[row] = S - len(ids)
    return tokens, pad_lens


def trim_to_eos(
    ids, eos_id: int, pad_id: int, extra_eos: tuple[int, ...] = ()
) -> list[int]:
    """Cut a generated id row at its first EOS/pad slot. ``extra_eos`` carries
    the active GenerationConfig.eos_ids, stripped like native EOS."""
    stops = {eos_id, pad_id, *extra_eos}
    out: list[int] = []
    for t in ids:
        if t in stops:
            break
        out.append(t)
    return out


def decodable_vocab_limit(tok, model_vocab_size: int) -> int:
    """Sampling range that can actually become text: the model head may be
    larger than the tokenizer (random-init 128k-vocab model + byte
    tokenizer), and a tokenizer may carry ids its decode() drops."""
    tok_limit = getattr(
        tok, "decodable_vocab_size", getattr(tok, "vocab_size", None)
    )
    return min(model_vocab_size, tok_limit or model_vocab_size)


_warned_unsampleable: set = set()


def sampling_vocab(tok, model_vocab_size: int, terminators=()):
    """(limit, allowed-or-None) restriction applied to logits before
    sampling: ``limit`` extends the decodable range just far enough to cover
    every terminator (EOS must stay sampleable); ``allowed`` is a bool
    [limit] numpy mask, or None when every id below ``limit`` is fair game.
    Terminators at or above the model head are unsampleable — warn once."""
    decodable = decodable_vocab_limit(tok, model_vocab_size)
    terms = sorted({int(t) for t in terminators})
    dropped = [t for t in terms if not 0 <= t < model_vocab_size]
    warn_key = (model_vocab_size, decodable, tuple(dropped))
    if dropped and warn_key not in _warned_unsampleable:
        _warned_unsampleable.add(warn_key)
        get_logger("vnsum.backend").warning(
            "terminator ids %s lie outside the model head (vocab %d) and "
            "can never be sampled; generation will run to max_new unless "
            "another terminator fires",
            dropped, model_vocab_size,
        )
    terms = [t for t in terms if 0 <= t < model_vocab_size]
    limit = max([decodable] + [t + 1 for t in terms])
    if limit == decodable:
        return limit, None
    allowed = np.zeros((limit,), dtype=bool)
    allowed[:decodable] = True
    allowed[terms] = True
    return limit, allowed


def terminator_ids(tok, gen) -> tuple[int, ...]:
    """The ONE effective stop-token set for done detection, sampleability
    and detok stripping: the tokenizer's EOS plus GenerationConfig.eos_ids."""
    return tuple(sorted({tok.eos_id, *gen.eos_ids}))


def mask_unsampleable(row_logits: torch.Tensor, allowed: torch.Tensor | None):
    """Apply a :func:`sampling_vocab` mask (as a bool tensor on the logits'
    device) to a [B, limit] logits slice: blocked ids get float32 min so
    neither argmax nor sampling can pick them. ``allowed=None`` is the
    identity."""
    if allowed is None:
        return row_logits
    return row_logits.masked_fill(~allowed, torch.finfo(torch.float32).min)


def resolve_max_new(
    max_new_tokens: int | None, config, backend_default: int
) -> int:
    """Decode budget: explicit argument > explicit config override > the
    backend's constructor default."""
    if max_new_tokens is not None:
        return max_new_tokens
    if config is not None and config.max_new_tokens is not None:
        return config.max_new_tokens
    return backend_default


def get_backend(spec: str, **kwargs) -> Backend:
    """Factory: "torch", "ollama" or "fake". The JAX package's "hf"
    (``HFBackend``, a ``transformers`` wrapper) is not ported yet (ROADMAP
    A5c)."""
    if spec == "fake":
        from .fake import FakeBackend

        return FakeBackend(**kwargs)
    if spec == "ollama":
        from .ollama import OllamaBackend

        return OllamaBackend(**kwargs)
    if spec == "torch":
        from .engine import TorchBackend

        return TorchBackend(**kwargs)
    if spec == "hf":
        raise NotImplementedError(
            "the hf backend (HFBackend) is not ported yet (ROADMAP A5c)")
    raise ValueError(f"unknown backend {spec!r} (use torch|ollama|fake)")
