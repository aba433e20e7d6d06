"""Ring attention: the sequence split over the ranks of a seq group.

Counterpart of ``vnsum_tpu/parallel/ring.py``: :func:`ring_attention` is the
per-rank body of its ``_ring_local`` in plain torch. Each rank keeps its
block of queries and walks the K/V blocks of every rank as they rotate
around the ring (:meth:`SeqGroup.ring_shift`), accumulating a flash-style
online softmax, so no rank holds the whole [S, S] scores or the whole K/V.
A block whose keys all come after the rank's queries is passed on without
being computed: the causal mask hides it whole, so it would change nothing.
The masks are global: causal over global positions, and each row's left
pad where there is one. The last block is not rotated on, since nobody
would read it.

The long-context prefill runs it for seq groups of more than one rank. On
a card each block is still dense attention in plain torch (the JAX ring is
XLA code too, no Pallas kernel). Its f32 transients, the scores, p and the
mask of a block, grow with the square of a rank's shard (at 12,800 slots
and 24 heads one row's scores alone take 15.7 GB), so the queries go
through in slices of ``query_block`` rows, each with the same arithmetic
per row; the transients then stay near ``TRANSIENT_BYTES``. Under a
``model`` axis the heads are the rank's local ones.

Training differentiates it (:func:`ring_attention_fn`). JAX gets the
gradient from autodiff, the transpose of each ``ppermute`` being the
reverse shift; here :class:`RingAttentionFn` writes it out as the flash
backward over a second ring. The forward keeps this rank's q, k, v, the
output and each row's log-sum-exp, not any block's p. The backward walks
the K/V blocks again in the same order, with the same masks, skips and
query slices, recomputes each block's p from the log-sum-exp in f32, keeps
dq here and sends each block's dk and dv on with it, so that after the
ring's n shifts they are back with the block's owner.
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


def _allowed(q_pos, k_pos, pad_lens):
    """[B or 1, s, Sk]: causal over global positions, and each row's left pad."""
    allowed = (q_pos[:, None] >= k_pos[None, :])[None]
    if pad_lens is not None:
        allowed = allowed & (k_pos[None, None, :] >= pad_lens.long()[:, None, None])
    return allowed


def _ring_forward(q, k, v, q_per_kv, group, pad_lens, query_block):
    """The online softmax's accumulators over every rank's K/V: o [B, KV,
    G, Sq, hd], m and l [B, KV, G, Sq], all f32."""
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
        for lo in range(0, Sq, step):
            hi = min(lo + step, Sq)
            scores = torch.einsum("bskgh,bckh->bkgsc", qg[:, lo:hi], kf) * scale
            allowed = _allowed(q_pos[lo:hi], k_pos, pad_lens)  # [B or 1, s, Sk]
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
    return o, m, l


def _output(o, l, q):
    """[B, KV, G, Sq, hd] accumulators -> [B, Sq, H, hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def ring_attention(
    q: torch.Tensor,          # [B, Sq, H, hd], this rank's block of queries
    k: torch.Tensor,          # [B, Sk, KV, hd], this rank's block of keys
    v: torch.Tensor,          # [B, Sk, KV, hd]
    q_per_kv: int,
    group: SeqGroup,
    pad_lens: torch.Tensor | None = None,  # [B] global left pads; None: no pad
    query_block: int | None = None,
) -> torch.Tensor:
    """Attention of this rank's queries over the whole sequence; returns
    [B, Sq, H, hd] in q's dtype. Rank r holds global positions
    [r * Sq, (r + 1) * Sq). ``query_block`` rows of queries go through at
    a time (default :func:`default_query_block`); every row's arithmetic
    is the same at any block. Collective: every rank of ``group`` calls
    it. Not differentiable: training takes :func:`ring_attention_fn`."""
    o, _, l = _ring_forward(q, k, v, q_per_kv, group, pad_lens, query_block)
    return _output(o, l, q)


def _home(group: SeqGroup, dk: torch.Tensor, dv: torch.Tensor):
    """The backward's last shift: each block's dk and dv go on from the
    rank before its owner to the owner."""
    return group.ring_shift(dk), group.ring_shift(dv)


def _ring_backward(q, k, v, out, lse, dout, q_per_kv, group, pad_lens, query_block):
    """(dq, dk, dv) of this rank's q, k, v, in their dtypes: the flash
    backward over the ring, every product in f32."""
    n, idx = group.world, group.rank
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = q_per_kv
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    step = query_block or default_query_block(B, H, k.shape[1])

    qg = q.reshape(B, Sq, KV, G, hd).float()
    dog = dout.reshape(B, Sq, KV, G, hd).float()
    # each row's rowsum(dO * O): [B, KV, G, Sq]
    delta = (dog * out.reshape(B, Sq, KV, G, hd).float()).sum(-1).permute(0, 2, 3, 1)
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    dq = torch.zeros_like(qg)

    k_cur, v_cur = k, v
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    for i in range(n):
        src = (idx - i) % n  # the rank this K/V block (and its dk, dv) belongs to
        if src <= idx:  # the forward's skip: a block after every query adds nothing
            kf, vf = k_cur.float(), v_cur.float()
            k_pos = src * Sq + torch.arange(k_cur.shape[1], device=dev)
            for lo in range(0, Sq, step):
                hi = min(lo + step, Sq)
                hidden = ~_allowed(q_pos[lo:hi], k_pos, pad_lens)[:, None, None]
                # p from the forward's log-sum-exp: [B, KV, G, s, Sk]
                scores = torch.einsum("bskgh,bckh->bkgsc", qg[:, lo:hi], kf) * scale
                p = torch.exp(scores - lse[..., lo:hi, None]).masked_fill_(hidden, 0.0)
                del scores
                dv_cur += torch.einsum("bkgsc,bskgh->bckh", p, dog[:, lo:hi])
                dp = torch.einsum("bskgh,bckh->bkgsc", dog[:, lo:hi], vf)
                ds = p.mul_(dp.sub_(delta[..., lo:hi, None]))  # p * (dp - delta), in p
                del dp
                dq[:, lo:hi] += torch.einsum("bkgsc,bckh->bskgh", ds, kf) * scale
                dk_cur += torch.einsum("bkgsc,bskgh->bckh", ds, qg[:, lo:hi]) * scale
                del ds, hidden
            del kf, vf
        if i < n - 1:
            k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
            dk_cur, dv_cur = group.ring_shift(dk_cur), group.ring_shift(dv_cur)
    dk_cur, dv_cur = _home(group, dk_cur, dv_cur)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype))


class RingAttentionFn(torch.autograd.Function):
    """:func:`ring_attention` with its gradient: the forward keeps q, k, v,
    the output and each row's log-sum-exp ``m + log l``; the backward is
    :func:`_ring_backward`. Both are collective over ``group``."""

    @staticmethod
    def forward(ctx, q, k, v, q_per_kv, group, pad_lens, query_block):
        o, m, l = _ring_forward(q, k, v, q_per_kv, group, pad_lens, query_block)
        out = _output(o, l, q)
        # a row with no key to attend (a pad) gets -inf: its p is masked to 0
        lse = m + torch.log(l)
        del o, m, l
        ctx.save_for_backward(q, k, v, out, lse, pad_lens)
        ctx.q_per_kv, ctx.group, ctx.query_block = q_per_kv, group, query_block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, pad_lens = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout, ctx.q_per_kv, ctx.group,
                                    pad_lens, ctx.query_block)
        return dq, dk, dv, None, None, None, None


def ring_attention_fn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_per_kv: int,
    group: SeqGroup,
    pad_lens: torch.Tensor | None = None,
    query_block: int | None = None,
) -> torch.Tensor:
    """:func:`ring_attention`, differentiable in q, k and v: the
    ``attention_fn`` of ``forward_train`` over a ``seq`` group
    (``partial(ring_attention_fn, group=mesh.group("seq"))``)."""
    return RingAttentionFn.apply(q, k, v, q_per_kv, group, pad_lens, query_block)
