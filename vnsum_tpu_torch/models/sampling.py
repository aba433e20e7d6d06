"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``vnsum_tpu/models/sampling.py``. Greedy is exact (argmax,
first index on ties, as ``jnp.argmax``). Sampled rows draw from a
``torch.Generator`` seeded only by (seed, row uid, step), so a row's stream
never depends on its place in the batch; the streams are not the JAX
package's threefry bits (a different generator), only the same law.

Also home to the speculative-decoding acceptance rule
(:func:`draft_acceptance_rows`): exact argmax prefix matching for greedy,
rejection-style acceptance against the filtered distribution for sampling.
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


def draft_acceptance_rows(
    logits: torch.Tensor,   # [B, K+1, V] float32: verify-step logits
    drafts: torch.Tensor,   # [B, K] int: proposed continuation tokens
    n_draft: torch.Tensor,  # [B] int: how many of drafts are real
    seeds: list | None = None,  # [B][K+1] generator seeds (row_seed); sampling only
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decide per row how many drafted tokens survive verification.

    Position i's logits are conditioned on the current token plus drafts
    d_1..d_i, so logits[:, i] is the model's next-token distribution after
    accepting i drafts. Returns ``(m [B], next_token [B])``: the row keeps
    drafts d_1..d_m and ``next_token`` is the model's own token after them,
    so every verify step retires at least one token.

    Greedy: accept while argmax(logits[:, i-1]) == d_i (exact prefix match:
    the spec stream is identical to plain greedy decode).
    Sampled: accept d_i with probability p_{i-1}(d_i) under the filtered
    distribution; on rejection sample from the residual (p with the rejected
    draft masked out, renormalized); when every draft survives, sample
    position m freely. Position i draws its uniform, its residual sample and
    its free sample, in that order, from one generator seeded with
    ``seeds[b][i]``, so a row's randomness is keyed by the stream position
    it would emit, never by how many drafts it accepted before."""
    B, K = drafts.shape
    drafts = drafts.long()
    real = torch.arange(K, device=drafts.device)[None, :] < n_draft.long()[:, None]

    if temperature <= 0.0:
        g = torch.argmax(logits, dim=-1)                                   # [B, K+1]
        ok = (g[:, :K] == drafts) & real
        m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        return m, torch.gather(g, 1, m[:, None])[:, 0]

    f = filter_logits(logits, temperature, top_k, top_p)                   # [B, K+1, V]
    probs = torch.softmax(f, dim=-1)
    p_draft = torch.gather(probs[:, :K], -1, drafts[..., None])[..., 0]    # [B, K]
    blocked = torch.zeros_like(f[:, :K], dtype=torch.bool).scatter_(-1, drafts[..., None], True)
    probs_resid = torch.softmax(
        f[:, :K].masked_fill(blocked, torch.finfo(torch.float32).min), dim=-1
    )
    u = torch.empty((B, K), dtype=torch.float32, device=logits.device)
    resid = torch.empty((B, K + 1), dtype=torch.long, device=logits.device)
    free = torch.empty((B, K + 1), dtype=torch.long, device=logits.device)
    for b in range(B):
        for i in range(K + 1):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(seeds[b][i])
            if i < K:
                u[b, i] = torch.rand((), generator=gen, device=logits.device)
                resid[b, i] = torch.multinomial(probs_resid[b, i], 1, generator=gen)[0]
            free[b, i] = torch.multinomial(probs[b, i], 1, generator=gen)[0]
    resid[:, K] = free[:, K]
    ok = (u < p_draft) & real
    m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    rejected = m < n_draft.long()  # m == n_draft: the chain never broke
    nxt = torch.where(
        rejected,
        torch.gather(resid, 1, m[:, None])[:, 0],
        torch.gather(free, 1, m[:, None])[:, 0],
    )
    return m, nxt
