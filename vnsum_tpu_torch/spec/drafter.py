"""Draft-model-free n-gram reference drafter.

Copy of ``vnsum_tpu/spec/drafter.py``. Summarization output overlaps its
source document far more than free-form generation does: map and reduce
calls largely re-emit spans of the text they were handed. So instead of a
draft model, the drafter suffix-matches the tokens already emitted against
the request's source-document tokens and proposes the continuation that
follows the longest match ("Inference with Reference", arXiv:2304.04487).
Verification (the engine's spec path) feeds the k proposed tokens through
ONE batched forward and accepts the longest prefix the model itself would
have produced, so greedy outputs are identical to plain decode.

Two implementations of the same contract:

- :func:`propose_drafts`: torch on fixed shapes, so it runs on the device
  inside the engine's spec step (no host sync on the decode path);
- :func:`propose_drafts_host`: plain numpy mirror for host-side callers and
  the equivalence tests that pin the torch version's semantics.

Both return, per batch row, up to ``k`` draft tokens and the count actually
proposed. Rows with no reference, no match, or an exhausted reference
propose zero drafts: the verify step then retires one token per step,
exactly as plain decode.
"""
from __future__ import annotations

import numpy as np
import torch

# sentinel for "no token here" in history tails / reference padding; never a
# valid token id, so it can never produce a spurious match
NO_TOKEN = -1


def encode_references(
    tok,
    references: list[str | None],
    max_ref_tokens: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side packing of per-request reference texts into fixed-shape
    buffers: (ref_tokens [B, R] int32 padded with NO_TOKEN, ref_lens [B]).

    ``R`` is the longest encoded reference clamped to ``max_ref_tokens``
    (references are matched, not attended — truncating one only costs draft
    coverage of its tail, never correctness). ``None`` entries get length 0:
    those rows never draft."""
    encoded: list[list[int]] = []
    for r in references:
        if not r:
            encoded.append([])
            continue
        ids = tok.encode(r, add_bos=False)
        encoded.append(ids[:max_ref_tokens])
    R = max((len(e) for e in encoded), default=0)
    R = max(R, 1)  # zero-width buffers make degenerate jit shapes
    out = np.full((len(encoded), R), NO_TOKEN, dtype=np.int32)
    lens = np.zeros((len(encoded),), dtype=np.int32)
    for i, ids in enumerate(encoded):
        out[i, : len(ids)] = ids
        lens[i] = len(ids)
    return out, lens


def propose_drafts(ref: torch.Tensor, ref_lens: torch.Tensor, tail: torch.Tensor, k: int):
    """Batched n-gram suffix-match drafting on tensors (no host sync).

    ref       [B, R] int — reference tokens, NO_TOKEN-padded
    ref_lens  [B]    int — valid prefix length of each row's reference
    tail      [B, N] int — the last N tokens of each row's emitted stream
                           (tail[:, -1] is the most recent, i.e. the token
                           about to be fed to the model), NO_TOKEN where the
                           stream is shorter than N
    k         int        — max draft tokens to propose

    Returns (drafts [B, k] int64, n_draft [B] int64). drafts[:, i] for
    i >= n_draft are 0 (valid-but-ignored ids: the verify step masks them
    out of acceptance, they only pad the fixed-shape forward).

    Match rule: for every reference position p, the match length m(p) is the
    number of trailing emitted tokens that equal ref[p - i] walking
    backwards (capped at N). The winner maximizes (m, p): longest suffix
    match first, latest occurrence to break ties. Rows whose best m == 0 or
    whose winning position has no continuation left propose nothing."""
    B, R = ref.shape
    N = tail.shape[1]
    dev = ref.device
    ref = ref.long()
    ref_lens = ref_lens.long()
    tail_rev = tail.long().flip(1)  # tail_rev[:, i] = i-th most recent token

    # p_idx[p, i] = p - i: reference position holding the i-th most recent
    # token if the match ends at p
    p_idx = torch.arange(R, device=dev)[:, None] - torch.arange(N, device=dev)[None, :]
    valid = p_idx >= 0
    gathered = ref[:, p_idx.clamp(0, R - 1)]                          # [B, R, N]
    eq = (
        (gathered == tail_rev[:, None, :])
        & valid[None]
        & (tail_rev[:, None, :] != NO_TOKEN)
        & (gathered != NO_TOKEN)
    )
    # consecutive-match length along the suffix axis
    m = torch.cumprod(eq.long(), dim=2).sum(dim=2)                    # [B, R]
    # a position only counts inside the row's real reference AND with at
    # least one continuation token left
    pos = torch.arange(R, device=dev)[None, :]
    usable = (pos + 1) < ref_lens[:, None]
    m = torch.where(usable, m, torch.zeros_like(m))
    best = torch.argmax(m * (R + 1) + pos, dim=1)                     # [B]
    best_m = torch.gather(m, 1, best[:, None])[:, 0]

    # continuation after the match, clamped at the reference end
    start = best + 1
    avail = (ref_lens - start).clamp_min(0)
    n_draft = torch.where(best_m > 0, avail.clamp_max(k), torch.zeros_like(avail))
    ref_pad = torch.cat([ref, torch.zeros((B, k), dtype=ref.dtype, device=dev)], dim=1)
    idx = start.clamp_max(R)[:, None] + torch.arange(k, device=dev)[None, :]
    drafts = torch.gather(ref_pad, 1, idx)
    # zero the unproposed tail so NO_TOKEN padding never reaches the forward
    live = torch.arange(k, device=dev)[None, :] < n_draft[:, None]
    drafts = torch.where(live, drafts, torch.zeros_like(drafts))
    return drafts, n_draft


def propose_drafts_host(
    ref: np.ndarray, ref_lens: np.ndarray, tail: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of :func:`propose_drafts`: identical semantics, host
    execution. The straightforward per-row loop doubles as executable
    documentation of the match rule; tests assert the two agree."""
    B, R = ref.shape
    N = tail.shape[1]
    drafts = np.zeros((B, k), dtype=np.int32)
    n_draft = np.zeros((B,), dtype=np.int32)
    for b in range(B):
        L = int(ref_lens[b])
        best_m, best_p = 0, -1
        for p in range(L - 1):  # p = L-1 has no continuation: never usable
            m = 0
            for i in range(N):
                if p - i < 0:
                    break
                t = int(tail[b, N - 1 - i])
                if t == NO_TOKEN or int(ref[b, p - i]) != t:
                    break
                m += 1
            if m >= best_m and m > 0:  # ties break toward the later p
                best_m, best_p = m, p
        if best_m == 0:
            continue
        n = min(k, L - (best_p + 1))
        drafts[b, :n] = ref[b, best_p + 1 : best_p + 1 + n]
        n_draft[b] = n
    return drafts, n_draft


def history_tail(out: np.ndarray, out_lens: np.ndarray, cur: np.ndarray,
                 n: int) -> np.ndarray:
    """Host helper: the last ``n`` tokens of each row's emitted stream —
    out[b, :out_lens[b]] followed by cur[b] — NO_TOKEN-padded on the left.
    The engine's spec step computes the same thing on the device; this
    exists for host-side drafting (propose_drafts_host callers)."""
    B = out.shape[0]
    tail = np.full((B, n), NO_TOKEN, dtype=np.int32)
    for b in range(B):
        hist = list(out[b, : int(out_lens[b])]) + [int(cur[b])]
        take = hist[-n:]
        tail[b, n - len(take):] = take
    return tail
