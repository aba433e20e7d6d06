"""The port's radix index (vnsum_tpu_torch.cache.radix) against the JAX
package's (vnsum_tpu.cache.radix): the scenarios of
tests/test_cache_radix.py, and seeded random operation sequences, run as the
same operation sequence on both indexes. Every match (blocks, tokens),
probe, insert result (new blocks and their offsets, so the eviction order),
stats dict and pin count along the way must be equal, and the JAX tests'
own properties must hold on the port's side."""
from __future__ import annotations

import threading

import numpy as np
import pytest

from vnsum_tpu.cache.radix import RadixIndex as JaxRadixIndex
from vnsum_tpu_torch.cache.radix import RadixIndex


def seq(n, base=0):
    return [base + i for i in range(n)]


def snap(idx) -> tuple:
    return ("stats", idx.stats_dict(), idx.blocks_used, idx.pinned_blocks)


class Recorder:
    """Runs operations on one index and records every result."""

    def __init__(self, cls, num_blocks, block_tokens):
        self.idx = cls(num_blocks, block_tokens)
        self.trace: list = []
        self.live: dict = {}

    def insert(self, tokens, upto):
        new = self.idx.insert(tokens, upto)
        self.trace.append(("insert", new))
        return new

    def match(self, name, tokens, max_tokens=None):
        m = self.idx.match(tokens, max_tokens)
        self.live[name] = m
        self.trace.append(("match", m.blocks, m.tokens))
        return m

    def release(self, name):
        self.idx.release(self.live[name])
        self.trace.append(snap(self.idx))

    def probe(self, tokens, max_tokens=None):
        n = self.idx.probe(tokens, max_tokens)
        self.trace.append(("probe", n))
        return n


def block_aligned(r):
    r.insert(seq(10), upto=10)  # 2 blocks of 4
    m = r.match("a", seq(10))
    assert m.tokens == 8 and len(m.blocks) == 2
    r.release("a")


def max_tokens(r):
    r.insert(seq(12), upto=12)
    assert r.match("a", seq(12), max_tokens=7).tokens == 4
    r.release("a")


def divergent_suffixes(r):
    a = seq(4) + [100, 101, 102, 103]
    b = seq(4) + [200, 201, 202, 203]
    r.insert(a, upto=8)
    r.insert(b, upto=8)
    assert r.idx.blocks_used == 3  # a shared head and two tails
    ma, mb = r.match("a", a), r.match("b", b)
    assert ma.blocks[0] == mb.blocks[0] and ma.blocks[1] != mb.blocks[1]
    r.release("a")
    r.release("b")


def chain_reuse(r):
    assert len(r.insert(seq(8), upto=8)) == 2
    assert r.insert(seq(8), upto=8) == []
    assert r.idx.stats.inserted_blocks == 2


def readonly_probe(r):
    r.insert(seq(8), upto=8)
    before = r.idx.stats.lookups
    assert r.probe(seq(8)) == 8 and r.probe(seq(3)) == 0
    assert r.idx.stats.lookups == before


def lru_eviction(r):
    r.insert(seq(4, 0), upto=4)
    r.insert(seq(4, 100), upto=4)
    r.match("a", seq(4, 0))  # the first chain becomes the most recent
    r.release("a")
    r.insert(seq(4, 200), upto=4)
    assert r.idx.stats.evictions == 1
    assert (r.probe(seq(4, 0)), r.probe(seq(4, 100)), r.probe(seq(4, 200))) == (4, 0, 4)


def pinned_blocks(r):
    r.insert(seq(8), upto=8)  # one 2-block chain fills the pool
    r.match("a", seq(8))
    assert r.insert(seq(4, 500), upto=4) == []  # nothing evictable while pinned
    assert r.idx.stats.evictions == 0 and r.probe(seq(8)) == 8
    r.release("a")
    assert len(r.insert(seq(4, 500), upto=4)) == 1
    assert r.idx.stats.evictions == 1


def tail_first(r):
    r.insert(seq(6), upto=6)  # one 3-block chain
    r.insert(seq(2, 900), upto=2)
    assert r.idx.stats.evictions == 1
    assert r.probe(seq(6)) == 4  # the chain's head survives


def idempotent_release(r):
    r.insert(seq(4), upto=4)
    r.match("a", seq(4))
    r.release("a")
    r.release("a")  # a no-op: refs never go negative
    m2 = r.match("b", seq(4))
    assert all(n.refs == 1 for n in m2.nodes)
    r.release("b")


def churn(r):
    """The engine thread's side of the JAX package's probes-during-mutation
    test: match / insert / release churn with eviction."""
    for i in range(300):
        tokens = seq(16, (i % 5) * 1000)
        r.match("m", tokens, max_tokens=len(tokens) - 1)
        r.insert(tokens, upto=12)
        r.release("m")
    assert 0 <= r.idx.blocks_used <= 16


# scenario -> (function, num_blocks, block_tokens), as tests/test_cache_radix.py
SCENARIOS = {
    "block_aligned": (block_aligned, 8, 4), "max_tokens": (max_tokens, 8, 4),
    "divergent_suffixes": (divergent_suffixes, 8, 4), "chain_reuse": (chain_reuse, 8, 4),
    "readonly_probe": (readonly_probe, 8, 4), "lru_eviction": (lru_eviction, 2, 4),
    "pinned_blocks": (pinned_blocks, 2, 4), "tail_first": (tail_first, 3, 2),
    "idempotent_release": (idempotent_release, 4, 2), "churn": (churn, 16, 4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name):
    fn, n, blk = SCENARIOS[name]
    runs = {}
    for side, cls in (("port", RadixIndex), ("jax", JaxRadixIndex)):
        r = Recorder(cls, n, blk)
        fn(r)
        r.trace.append(snap(r.idx))
        runs[side] = r.trace
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("seed", range(5))
def test_random_operations_match_jax(seed):
    """Seeded random mixes of match, insert (whole and hint-bounded),
    probe and release over a tight pool, prompts sharing headers of a few
    blocks: every result equal, evictions included."""
    rng = np.random.default_rng(seed)
    heads = [list(rng.integers(0, 50, 12)) for _ in range(3)]
    ops = []
    for step in range(200):
        tokens = heads[rng.integers(3)][: rng.integers(4, 13)] + list(rng.integers(0, 4, 6))
        ops.append((int(rng.integers(4)), [int(t) for t in tokens], int(rng.integers(1, 19))))
    runs = {}
    for side, cls in (("port", RadixIndex), ("jax", JaxRadixIndex)):
        r = Recorder(cls, 7, 3)
        held: list = []
        for i, (op, tokens, upto) in enumerate(ops):
            if op == 0:
                r.match(i, tokens, max_tokens=len(tokens) - 1)
                held.append(i)
            elif op == 1:
                r.insert(tokens, upto)
            elif op == 2:
                r.probe(tokens)
            elif held:
                r.release(held.pop(0))
        for name in held:
            r.release(name)
        r.trace.append(snap(r.idx))
        runs[side] = r.trace
    assert runs["port"] == runs["jax"]
    assert any(t[0] == "stats" and t[1]["evictions"] for t in runs["port"])


def test_concurrent_probes_against_mutation():
    """Probing threads race the engine thread's churn on the port's index:
    no exception, and the churn's final state equals the JAX index's after
    the same churn without probes (probes change nothing)."""
    r = Recorder(RadixIndex, 16, 4)
    stop = threading.Event()
    errors: list = []

    def prober():
        while not stop.is_set():
            try:
                r.idx.probe(seq(16, 0))
                r.idx.probe(seq(8, 100))
            except Exception as e:  # pragma: no cover - the assertion target
                errors.append(e)
                return

    threads = [threading.Thread(target=prober) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        churn(r)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    j = Recorder(JaxRadixIndex, 16, 4)
    churn(j)
    assert snap(r.idx) == snap(j.idx)


@pytest.mark.parametrize("n,blk", [(0, 4), (4, 0)])
def test_rejects_empty_pool_or_block(n, blk):
    for cls in (RadixIndex, JaxRadixIndex):
        with pytest.raises(ValueError):
            cls(n, blk)
