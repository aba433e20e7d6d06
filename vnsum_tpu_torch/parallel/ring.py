"""Ring attention: the sequence split over the ranks of a seq group.

Counterpart of ``vnsum_tpu/parallel/ring.py``: :func:`ring_attention` is the
per-rank body of its ``_ring_local`` in plain torch. Each rank keeps its
block of queries and walks the K/V blocks of every rank as they rotate
around the ring (:meth:`SeqGroup.ring_shift`), accumulating a flash-style
online softmax, so no rank holds the whole [S, S] scores or the whole K/V.
The masks are global: causal over global positions, and each row's left
pad. The last block is not rotated on, since nobody would read it.

The long-context prefill runs it for seq groups of more than one rank. On
a card each block is still dense attention in plain torch; a kernel that
returns per-block partials is later work (ROADMAP, with multi-GPU).
"""
from __future__ import annotations

import torch

from ..ops.flash_attention import NEG
from .seq import SeqGroup


def ring_attention(
    q: torch.Tensor,          # [B, Sq, H, hd], this rank's block of queries
    k: torch.Tensor,          # [B, Sk, KV, hd], this rank's block of keys
    v: torch.Tensor,          # [B, Sk, KV, hd]
    q_per_kv: int,
    group: SeqGroup,
    pad_lens: torch.Tensor,   # [B] global left pads
) -> torch.Tensor:
    """Attention of this rank's queries over the whole sequence; returns
    [B, Sq, H, hd] in q's dtype. Rank r holds global positions
    [r * Sq, (r + 1) * Sq). Collective: every rank of ``group`` calls it."""
    n, idx = group.world, group.rank
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = q_per_kv
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    qg = q.reshape(B, Sq, KV, G, hd).float()
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    o = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)

    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx - i) % n  # the rank this K/V block belongs to
        scores = torch.einsum("bskgh,bckh->bkgsc", qg, k_cur.float()) * scale
        k_pos = src * Sq + torch.arange(k_cur.shape[1], device=dev)
        # causal over global positions, and each row's left pad: [B, Sq, Sk]
        allowed = (q_pos[None, :, None] >= k_pos[None, None, :]) & (
            k_pos[None, None, :] >= pad_lens.long()[:, None, None]
        )
        # scores [B, KV, G, Sq, Sk]
        scores = scores.masked_fill(~allowed[:, None, None], NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - m_new)
        # a fully masked block would otherwise give exp(NEG - NEG) = 1
        p = torch.exp(scores - m_new[..., None]).masked_fill(~allowed[:, None, None], 0.0)
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum("bkgsc,bckh->bkgsh", p, v_cur.float())
        m = m_new
        if i < n - 1:
            k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
    out = o / l.clamp_min(1e-30)[..., None]
    # [B, KV, G, Sq, hd] -> [B, Sq, H, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
