"""Ring attention: the sequence split over the ranks of a seq group.

Counterpart of ``vnsum_tpu/parallel/ring.py``: :func:`ring_attention` is the
per-rank body of its ``_ring_local`` in plain torch. Each rank keeps its
block of queries and walks the K/V blocks of every rank as they rotate
around the ring (:meth:`SeqGroup.ring_shift`), accumulating a flash-style
online softmax, so no rank holds the whole [S, S] scores or the whole K/V.
A block whose keys all come after the rank's queries is passed on without
being computed: the causal mask hides it whole, so it would change nothing.
The masks are global: causal over global positions, and each row's left
pad. The last block is not rotated on, since nobody would read it.

The long-context prefill runs it for seq groups of more than one rank. On
a card each block is still dense attention in plain torch (the JAX ring is
XLA code too, no Pallas kernel). Its f32 transients, the scores, p and the
mask of a block, grow with the square of a rank's shard (at 12,800 slots
and 24 heads one row's scores alone take 15.7 GB), so the queries go
through in slices of ``query_block`` rows, each with the same arithmetic
per row; the transients then stay near ``TRANSIENT_BYTES``. Under a
``model`` axis the heads are the rank's local ones.
"""
from __future__ import annotations

import torch

from ..ops.flash_attention import NEG
from .seq import SeqGroup

# the f32 bytes of one slice's scores (B x H x rows x Sk x 4) the default
# query block aims at: p and the masked copies are of the same size
TRANSIENT_BYTES = 1 << 30


def default_query_block(B: int, H: int, Sk: int) -> int:
    """Query rows a slice so that one [B, H, rows, Sk] f32 tensor stays
    within TRANSIENT_BYTES: a multiple of 128 where that fits, at least 1."""
    rows = TRANSIENT_BYTES // max(B * H * Sk * 4, 1)
    return max(rows // 128 * 128, min(rows, 128), 1)


def ring_attention(
    q: torch.Tensor,          # [B, Sq, H, hd], this rank's block of queries
    k: torch.Tensor,          # [B, Sk, KV, hd], this rank's block of keys
    v: torch.Tensor,          # [B, Sk, KV, hd]
    q_per_kv: int,
    group: SeqGroup,
    pad_lens: torch.Tensor,   # [B] global left pads
    query_block: int | None = None,
) -> torch.Tensor:
    """Attention of this rank's queries over the whole sequence; returns
    [B, Sq, H, hd] in q's dtype. Rank r holds global positions
    [r * Sq, (r + 1) * Sq). ``query_block`` rows of queries go through at
    a time (default :func:`default_query_block`); every row's arithmetic
    is the same at any block. Collective: every rank of ``group`` calls
    it."""
    n, idx = group.world, group.rank
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = q_per_kv
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    step = query_block or default_query_block(B, H, k.shape[1])

    qg = q.reshape(B, Sq, KV, G, hd).float()
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    o = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)

    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx - i) % n  # the rank this K/V block belongs to
        if src > idx:
            # every key of the block comes after every query of this rank:
            # the causal mask hides it all, and the online softmax would
            # leave (m, l, o) exactly as they are (correction 1, p 0)
            if i < n - 1:
                k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
            continue
        kf, vf = k_cur.float(), v_cur.float()
        k_pos = src * Sq + torch.arange(k_cur.shape[1], device=dev)
        pad_ok = k_pos[None, None, :] >= pad_lens.long()[:, None, None]  # [B, 1, Sk]
        for lo in range(0, Sq, step):
            hi = min(lo + step, Sq)
            scores = torch.einsum("bskgh,bckh->bkgsc", qg[:, lo:hi], kf) * scale
            # causal over global positions, and each row's left pad: [B, s, Sk]
            allowed = (q_pos[lo:hi, None] >= k_pos[None, :])[None] & pad_ok
            # scores [B, KV, G, s, Sk]
            scores = scores.masked_fill(~allowed[:, None, None], NEG)
            m_old = m[..., lo:hi]
            m_new = torch.maximum(m_old, scores.amax(dim=-1))
            correction = torch.exp(m_old - m_new)
            # a fully masked block would otherwise give exp(NEG - NEG) = 1
            p = torch.exp(scores - m_new[..., None]).masked_fill(~allowed[:, None, None], 0.0)
            del scores
            l[..., lo:hi] = l[..., lo:hi] * correction + p.sum(dim=-1)
            o[..., lo:hi, :] = (o[..., lo:hi, :] * correction[..., None]
                                + torch.einsum("bkgsc,bckh->bkgsh", p, vf))
            m[..., lo:hi] = m_new
            del p, allowed
        del kf, vf
        if i < n - 1:
            k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
    out = o / l.clamp_min(1e-30)[..., None]
    # [B, KV, G, Sq, hd] -> [B, Sq, H, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
