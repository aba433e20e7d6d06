"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``vnsum_tpu/models/sampling.py``. Greedy is exact (argmax,
first index on ties, as ``jnp.argmax``). Sampled rows draw from a
``torch.Generator`` seeded only by (seed, row uid, step), so a row's stream
never depends on its place in the batch; the streams are not the JAX
package's threefry bits (a different generator), only the same law.
"""
from __future__ import annotations

import torch


def filter_logits(
    logits: torch.Tensor,   # [..., V] float32
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Temperature-scale then apply top-k / top-p cutoffs (blocked ids get
    float32 min). Caller guarantees temperature > 0."""
    neg = torch.finfo(torch.float32).min
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, torch.full_like(logits, neg), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative prob > top_p; keep at least one token
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, torch.full_like(logits, neg), logits)
    return logits


def row_seed(seed: int, uid: int, step: int) -> int:
    """Counter-based per-(row, step) seed: splitmix64 over the three ints."""
    x = (seed * 0x9E3779B97F4A7C15 + uid * 0xBF58476D1CE4E5B9 + step) & (2**64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (x ^ (x >> 31)) & (2**63 - 1)


def sample_logits(
    logits: torch.Tensor,   # [B, V] float32
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Returns sampled token ids [B] (int64). temperature==0 -> argmax."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_logits_rows(
    logits: torch.Tensor,   # [B, V] float32
    seeds: list[int],       # one generator seed per row (row_seed)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Per-row-seeded sampling: row i draws only from a generator seeded
    with seeds[i], so its stream is invariant to its batch position."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    out = []
    for row, s in zip(logits, seeds):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(s)
        out.append(sample_logits(row[None], gen, temperature, top_k, top_p))
    return torch.cat(out)
