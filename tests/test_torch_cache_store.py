"""The port's block store and PrefixCache facade (vnsum_tpu_torch.cache.store)
against the JAX package's (vnsum_tpu.cache.store), on the CPU.

The same numpy-seeded caches and block ids go through both. The port's
copies must give the JAX ones' pools and seeded caches bit for bit: the
write of a slab into a block, the gather of blocks into rows at per-row
offsets, with the JAX semantics of ``dynamic_slice`` /
``dynamic_update_slice`` (a start clamped to [0, C - BLK], a later write
over an earlier one where they meet), including padded scratch writes past
the cache; and the facade's inserts under eviction, done as one batched
copy in the port and one copy a block in JAX, must leave the same pool."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.cache import BlockStore as JaxBlockStore
from vnsum_tpu.cache import PrefixCache as JaxPrefixCache
from vnsum_tpu_torch.cache import BlockStore, PrefixCache

from test_torch_ops_flash import one_torch_thread  # noqa: F401

L, B, KV, C, HD = 2, 3, 2, 32, 4


def np_cache(seed, quantized=False, c=C, b=B):
    rng = np.random.default_rng(seed)
    if not quantized:
        return {n: rng.normal(size=(L, b, KV, c, HD)).astype(np.float32) for n in ("k", "v")}
    out = {n: rng.integers(-127, 128, size=(L, b, KV, c, HD), dtype=np.int8) for n in ("k", "v")}
    out.update({n: rng.random(size=(L, b, KV, c)).astype(np.float32) for n in ("ks", "vs")})
    return out


def to_jax(cache):
    return {n: jnp.asarray(v) for n, v in cache.items()}


def to_torch(cache, dtype=None):
    return {n: torch.from_numpy(v.copy()).to(dtype if dtype and v.dtype == np.float32
                                             and n in ("k", "v") else None)
            for n, v in cache.items()}


def stores(num_blocks, blk, quantized=False):
    kw = dict(n_layers=L, n_kv_heads=KV, head_dim=HD, quantized=quantized)
    return (BlockStore(num_blocks, blk, dtype=torch.float32, device="cpu", **kw),
            JaxBlockStore(num_blocks, blk, dtype=jnp.float32, **kw))


def assert_pools_equal(port, jax_pool):
    assert set(port) == set(jax_pool)
    for n in port:
        np.testing.assert_array_equal(port[n].numpy(), np.asarray(jax_pool[n]))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_write_blocks_match_jax(quantized):
    """Slabs of several rows into blocks, one of them written twice (the
    later slab wins) and one start past C - BLK (clamped), as JAX's
    write_block calls in the same order."""
    ts, js = stores(6, 8, quantized)
    src = np_cache(1, quantized)
    writes = [(1, 8, 3), (0, 30, 5), (2, 3, 3), (0, 0, 0), (2, 16, 1)]
    for row, slot, block in writes:
        js.write_block(to_jax(src), row, slot, block)
    ts.write_blocks(to_torch(src), *zip(*writes))
    assert_pools_equal(ts.pool, js.pool)
    assert ts.pool["k"][ts.scratch_id].abs().sum() == 0  # the scratch block stays zero


# (block ids a row, row starts, cache length): ragged rows padded with the
# scratch id; starts whose later blocks run past C - BLK and clamp onto it
GATHERS = {
    "aligned": ([[3, 5], [6, 6], [3, 5]], [4, 0, 16], 32),
    "clamped": ([[3, 5, 0], [6, 6, 6], [0, 3, 6]], [20, 0, 5], 32),
    "past_cache": ([[1, 2, 3, 4, 5]], [9], 40),
    "one_block": ([[2], [6], [4]], [0, 24, 31], 32),
}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", list(GATHERS))
def test_gather_matches_jax(case, quantized):
    """The port's gather into a cache that already holds values (so every
    write shows) equals JAX's on the same pool and ids, bit for bit."""
    ids, starts, c = GATHERS[case]
    ids, starts = np.array(ids, np.int32), np.array(starts, np.int32)
    b = len(ids)
    ts, js = stores(6, 8, quantized)
    src = np_cache(2, quantized, c=c, b=b)
    for block in range(6):
        js.write_block(to_jax(src), block % b, 3 * block, block)
    ts.write_blocks(to_torch(src), [k % b for k in range(6)], [3 * k for k in range(6)], range(6))
    assert_pools_equal(ts.pool, js.pool)
    dst = np_cache(3, quantized, c=c, b=b)
    want = js.gather(to_jax(dst), ids, starts)
    got = ts.gather(to_torch(dst), ids, starts)
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_bf16_write_gather_roundtrip():
    """A bf16 cache's slabs come back bit for bit at another row and
    offset; rows padded with the scratch block get zeros in their padded
    span only."""
    ts = BlockStore(8, 4, n_layers=L, n_kv_heads=KV, head_dim=HD, dtype=torch.bfloat16,
                    device="cpu")
    src = {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in np_cache(4).items()}
    ts.write_blocks(src, [1, 1], [8, 12], [3, 5])
    dst = {n: torch.ones_like(v) for n, v in src.items()}
    ts.gather(dst, np.array([[3, 5], [ts.scratch_id] * 2, [3, 5]]), np.array([4, 0, 16]))
    for n in ("k", "v"):
        want = src[n][:, 1, :, 8:16]
        assert torch.equal(dst[n][:, 0, :, 4:12], want)
        assert torch.equal(dst[n][:, 2, :, 16:24], want)
        # NB pads to 2: the scratch row's two blocks write zeros at 0-7
        assert torch.equal(dst[n][:, 1, :, :8], torch.zeros_like(dst[n][:, 1, :, :8]))
        assert torch.equal(dst[n][:, 1, :, 8:], torch.ones_like(dst[n][:, 1, :, 8:]))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_facade_matches_jax(quantized):
    """insert, probe, match, gather, release and stats_dict (hbm_bytes
    included) through both facades; the inserted block counts equal."""
    kw = dict(n_layers=L, n_kv_heads=KV, head_dim=HD, quantized=quantized)
    tp = PrefixCache(8, 4, dtype=torch.float32, device="cpu", **kw)
    jp = JaxPrefixCache(8, 4, dtype=jnp.float32, **kw)
    cache = np_cache(5, quantized)
    ids = list(range(10))
    n = tp.insert(to_torch(cache), row=0, slot_base=2, ids=ids, upto=9)
    assert n == jp.insert(to_jax(cache), row=0, slot_base=2, ids=ids, upto=9) == 2
    assert tp.probe(ids) == jp.probe(ids) == 8
    tm, jm = tp.match(ids, max_tokens=9), jp.match(ids, max_tokens=9)
    assert (tm.blocks, tm.tokens) == (jm.blocks, jm.tokens)
    scratch = tp.store.scratch_id
    block_ids = np.array([tm.blocks, [scratch] * 2, [scratch] * 2], np.int32)
    starts = np.array([2, 0, 0], np.int32)
    dst = np_cache(6, quantized)
    got = tp.gather(to_torch(dst), block_ids, starts)
    want = jp.gather(to_jax(dst), block_ids, starts)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        np.testing.assert_array_equal(got[name][:, 0, :, 2:10].numpy(), cache[name][:, 0, :, 2:10])
    tp.release(tm)
    jp.release(jm)
    assert tp.stats_dict() == jp.stats_dict()
    assert tp.stats_dict()["hbm_bytes"] == (2 * 9 * L * KV * 4 * (HD + 4 * quantized)
                                            * (1 if quantized else 4))


def test_insert_rows_under_eviction_matches_jax():
    """One batched insert of three rows into a 4-block pool: a later row's
    insert evicts blocks an earlier row just took, so a block is written
    twice. The port's single copy leaves the pool of JAX's copy-per-block
    inserts, row by row."""
    kw = dict(n_layers=L, n_kv_heads=KV, head_dim=HD)
    tp = PrefixCache(4, 4, dtype=torch.float32, device="cpu", **kw)
    jp = JaxPrefixCache(4, 4, dtype=jnp.float32, **kw)
    cache = np_cache(7)
    rows = [(0, 0, list(range(100, 112)), 12), (1, 4, list(range(200, 212)), 12),
            (2, 8, list(range(300, 308)), 8)]
    n = tp.insert_rows(to_torch(cache), rows)
    assert n == sum(jp.insert(to_jax(cache), *r) for r in rows) == 8
    assert tp.index.stats.evictions == jp.index.stats.evictions == 4
    assert_pools_equal(tp.store.pool, jp.store.pool)
    assert tp.stats_dict() == jp.stats_dict()
