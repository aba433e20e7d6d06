"""Radix prefix KV cache: cross-request prompt reuse for prefill.

Copy of ``vnsum_tpu/cache``. The prompts this system prefills share
prefixes by construction: map chunks share a template header
(strategies/prompts.py), iterative refinement re-feeds the prior summary,
hierarchical collapse re-feeds child summaries. This package keeps the KV
of prefilled token prefixes so later requests prefill only their suffix:

- :mod:`radix`: the host-side token-id radix index at block granularity,
  with ref-counting (live batches pin their matched blocks) and LRU
  eviction under a fixed block budget;
- :mod:`store`: the device block pool (one [L, KV, BLK, hd] slab per
  block, the stacked cache layout of models/llama.py) and
  :class:`~vnsum_tpu_torch.cache.store.PrefixCache`, the engine-facing
  facade over both.

Gathered K/V are bitwise copies of what a full prefill wrote, and the
resume prefill computes the same math over the same cache length; the
forward over [K, S) runs its projections as other GEMM shapes than the
whole prompt's, so on the card bf16 tiling may flip a near tie.
"""
from .radix import CacheStats, Match, RadixIndex
from .store import BlockStore, PrefixCache

__all__ = ["BlockStore", "CacheStats", "Match", "PrefixCache", "RadixIndex"]
