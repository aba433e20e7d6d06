"""Paged KV block store + the engine-facing PrefixCache facade.

Copy of ``vnsum_tpu/cache/store.py`` in PyTorch idiom. The pool mirrors the
stacked cache layout the attention kernels read (models/llama.py
init_kv_cache: [L, B, KV, C, hd], scales [L, B, KV, C]): one pool row per
block, [L, KV, BLK, hd] (and [L, KV, BLK] for an int8 cache's scales), so
both copies keep the layout.

Blocks are POSITION-CONTIGUOUS: a block holds the KV of BLK consecutive
prompt tokens at RoPE positions [off, off + BLK), wherever the row sat in
its producer batch. A left-padded batch places token position p of a row
at cache slot pad + p (models/llama.py prefill_positions), so a block taken
at slot pad_src + off pastes into any consumer row at slot pad_dst + off.

Two copies, each a few launches per cache tensor whatever the block count:

- :meth:`BlockStore.write_blocks`: the [slot, slot + BLK) slabs of a list of
  (batch row, slot) pairs into their pool blocks, in one advanced-index
  copy (insertion after prefill);
- :meth:`BlockStore.gather`: up to NB blocks a row into a batch cache at
  per-row slot offsets, in one advanced-index copy. Rows needing fewer
  blocks pad with the scratch block id; those writes land at slots the
  resume prefill overwrites (or a filler row nobody reads): see
  backend/engine.py's ``_prepare_resume`` for the slot arithmetic.

Both keep the JAX package's semantics, which are those of a sequence of
``dynamic_slice`` / ``dynamic_update_slice`` calls: a slab's start is
clamped to [0, C - BLK] (a padded write past the cache lands at C - BLK,
never raises), and where two writes meet the later one wins.

Under a ``mesh`` the pool holds this rank's KV heads (``model`` shards
them, as ``cache_specs`` shards the batch cache) and is replicated over
``data``: a block is position-contiguous KV that any later row may match,
on any data rank. The radix index is host state, the same on every rank,
since every rank runs the same program on the same prompts. A block
written from a batch row on data rank r is copied into r's pool and then
broadcast from r over the ``data`` group.
"""
from __future__ import annotations

import numpy as np
import torch

from ..analysis.sanitizers import to_device

from .radix import Match, RadixIndex


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _last_writes(keys: np.ndarray) -> np.ndarray:
    """Indices of the last occurrence of each key, in write order: the
    writes that survive a sequence of writes to these destinations."""
    _, first_from_end = np.unique(keys[::-1], return_index=True)
    return np.sort(len(keys) - 1 - first_from_end)


class BlockStore:
    """Device pool of ``num_blocks`` KV blocks, plus one scratch row (id
    ``num_blocks``) that pads ragged gathers; the radix index never hands
    it out, so it stays zero."""

    def __init__(
        self,
        num_blocks: int,
        block_tokens: int,
        *,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        dtype,
        quantized: bool = False,
        device="cuda",
        mesh=None,
    ) -> None:
        self.block_tokens = block_tokens
        self.scratch_id = num_blocks
        self.data = None
        if mesh is not None:
            from ..parallel.mesh import AXES

            model_size = mesh.shape.get(AXES.model, 1)
            if n_kv_heads % max(model_size, 1):
                raise ValueError(
                    f"n_kv_heads={n_kv_heads} is not divisible by mesh axis "
                    f"'{AXES.model}' ({model_size}); shrink that axis or "
                    "pick a TP-compatible model config"
                )
            n_kv_heads //= model_size
            self.data = mesh.group(AXES.data)
        shape = (num_blocks + 1, n_layers, n_kv_heads, block_tokens, head_dim)
        if quantized:
            self.pool = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            }
        else:
            self.pool = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
            }

    @property
    def hbm_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.pool.values())

    def _index(self, values: np.ndarray) -> torch.Tensor:
        # a copy that does not block the host (sanitizers.to_device), so the
        # engine's transfer guard passes the gather and the insert
        return to_device(np.ascontiguousarray(values, dtype=np.int64), self.pool["k"].device)

    # -- insertion -------------------------------------------------------

    def write_blocks(self, cache: dict, rows, slots, block_ids) -> None:
        """Copy the [slot, slot + BLK) slab of batch row ``rows[i]`` into
        pool block ``block_ids[i]`` for every i, as that many
        ``write_block`` calls in order would: each start clamped to
        [0, C - BLK], and a block written twice keeps the later slab."""
        ids = np.asarray(block_ids, dtype=np.int64)
        if ids.size == 0:
            return
        C = cache["k"].shape[3]
        keep = _last_writes(ids)
        rows = np.asarray(rows, dtype=np.int64)[keep]
        starts = np.clip(np.asarray(slots, dtype=np.int64)[keep], 0, C - self.block_tokens)
        ids = ids[keep]
        if self.data is None or self.data.world == 1:
            self._copy_in(cache, rows, starts, ids)
            return
        # rows are global batch rows; data rank r holds rows [r Bl, (r+1) Bl)
        Bl = cache["k"].shape[1]
        owner = rows // Bl
        for src in range(self.data.world):
            sel = owner == src
            if not sel.any():
                continue
            if src == self.data.rank:
                self._copy_in(cache, rows[sel] - src * Bl, starts[sel], ids[sel])
            ids_t = self._index(ids[sel])
            for buf in self.pool.values():
                buf[ids_t] = self.data.broadcast(buf[ids_t], src)

    def _copy_in(self, cache: dict, rows, starts, ids) -> None:
        """Pool block ``ids[i]`` = the [starts[i], + BLK) slab of batch row
        ``rows[i]``; ids distinct."""
        rows_t = self._index(rows)[:, None]
        slots_t = self._index(starts[:, None] + np.arange(self.block_tokens))
        ids_t = self._index(ids)
        for name, buf in cache.items():
            # advanced indices on dims 1 and 3 of [L, B, KV, C(, hd)] come
            # first: [P, BLK, L, KV(, hd)] -> the pool's [P, L, KV, BLK(, hd)]
            self.pool[name][ids_t] = buf[:, rows_t, :, slots_t].movedim(1, 3)

    def write_block(self, cache: dict, row: int, slot: int, block_id: int) -> None:
        """Copy the [slot, slot + BLK) slab of batch ``row`` into pool block
        ``block_id`` (the start clamped to [0, C - BLK])."""
        self.write_blocks(cache, [row], [slot], [block_id])

    # -- gather ----------------------------------------------------------

    def gather(self, cache: dict, block_ids: np.ndarray, starts: np.ndarray) -> dict:
        """Seed ``cache`` (a [L, B, KV, C, hd] batch cache) in place with
        pool blocks: row b gets block_ids[b, i] at slot starts[b] + i * BLK,
        each start clamped to [0, C - BLK], later blocks over earlier ones
        where clamping makes them meet. ``block_ids`` is [B, NB'] (any NB');
        it is padded to a power of two NB with the scratch id, as the JAX
        package pads it. Returns ``cache``."""
        BLK = self.block_tokens
        B, nb = block_ids.shape
        NB = _pow2_at_least(max(nb, 1))
        ids = np.full((B, NB), self.scratch_id, dtype=np.int64)
        ids[:, :nb] = block_ids
        C = cache["k"].shape[3]
        dst = np.clip(np.asarray(starts, dtype=np.int64)[:, None] + np.arange(NB) * BLK,
                      0, C - BLK)
        # one write a (row, block, token), in the order the JAX loop writes
        shape = (B, NB, BLK)
        rows = np.broadcast_to(np.arange(B)[:, None, None], shape).ravel()
        slots = (dst[:, :, None] + np.arange(BLK)).ravel()
        src = np.broadcast_to(ids[:, :, None], shape).ravel()
        toks = np.broadcast_to(np.arange(BLK), shape).ravel()
        keep = _last_writes(rows * C + slots)
        rows_t, slots_t = self._index(rows[keep]), self._index(slots[keep])
        src_t, toks_t = self._index(src[keep]), self._index(toks[keep])
        for name, buf in cache.items():
            # both sides index as [P, L, KV(, hd)]
            buf[:, rows_t, :, slots_t] = self.pool[name][src_t, :, :, toks_t]
        return cache


class PrefixCache:
    """Radix index + block store, the one object the engine talks to.

    The engine thread does all mutation (match with pin, gather, insert);
    other threads may only :meth:`probe`, the contract of cache/radix.py."""

    def __init__(
        self,
        num_blocks: int,
        block_tokens: int,
        *,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        dtype,
        quantized: bool = False,
        device="cuda",
        mesh=None,
    ) -> None:
        self.block_tokens = block_tokens
        self.index = RadixIndex(num_blocks, block_tokens)
        self.store = BlockStore(
            num_blocks, block_tokens, n_layers=n_layers, n_kv_heads=n_kv_heads,
            head_dim=head_dim, dtype=dtype, quantized=quantized, device=device, mesh=mesh,
        )

    def match(self, ids, max_tokens: int | None = None) -> Match:
        return self.index.match(ids, max_tokens)

    def release(self, match: Match) -> None:
        self.index.release(match)

    def probe(self, ids, max_tokens: int | None = None) -> int:
        return self.index.probe(ids, max_tokens)

    def gather(self, cache: dict, block_ids, starts) -> dict:
        return self.store.gather(cache, block_ids, starts)

    def insert_rows(self, cache: dict, rows) -> int:
        """Index each ``(row, slot_base, ids, upto)`` of ``rows`` in order
        (tokens[:upto] of a freshly prefilled batch row that sits left-padded
        at ``slot_base``), then copy every newly allocated block's KV out of
        ``cache`` in one :meth:`BlockStore.write_blocks`. The pool ends as
        a copy after each row's insert would leave it: a block that a later
        row's insert evicted and took keeps the later row's slab. Returns
        the number of new blocks."""
        pairs = [(row, base + off, block)
                 for row, base, ids, upto in rows
                 for block, off in self.index.insert(ids, upto)]
        if pairs:
            self.store.write_blocks(cache, *zip(*pairs))
        return len(pairs)

    def insert(self, cache: dict, row: int, slot_base: int, ids, upto: int) -> int:
        """Index tokens[:upto] of one freshly prefilled row and copy its
        newly allocated blocks' KV out of ``cache`` (whose row sits
        left-padded at ``slot_base``). Returns the number of new blocks."""
        return self.insert_rows(cache, [(row, slot_base, ids, upto)])

    def stats_dict(self) -> dict:
        d = self.index.stats_dict()
        d["block_tokens"] = self.block_tokens
        d["hbm_bytes"] = self.store.hbm_bytes
        return d
