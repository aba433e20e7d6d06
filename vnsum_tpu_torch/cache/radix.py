"""Token-id radix index over fixed-size blocks, with ref-counts + LRU.

Copy of ``vnsum_tpu/cache/radix.py``. The index is pure host state: a trie
whose edges are ``block_tokens``-long runs of token ids, each node owning
one block id in the device pool (cache/store.py). Matching walks whole
blocks only: a prefix is reusable at block granularity, the paged-KV
compromise (vLLM, SGLang's RadixAttention) that keeps device copies
rectangular.

Concurrency contract: ALL mutation (pinning matches, inserting chains,
eviction, which happens only inside an insert's allocation) runs on the one
engine thread; other threads may only :meth:`probe`. Everything locks, so a
probe never observes a half-linked chain; the no-pin window between
``insert`` and the pool write is safe only because no other allocator
exists.

Eviction: leaves (no children) with refcount 0, least recently used first.
Recency IS the ``_evictable`` dict's insertion order (a refresh moves a node
to the MRU end); there are no timestamps. A pinned block is never
reallocated while a live batch's gather may still read it.

Token ids are any hashable scalars: ints for the tokenizers, whitespace
words for FakeBackend's mirror.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Hashable, Sequence


@dataclass
class CacheStats:
    """Host-side accounting of the index."""

    lookups: int = 0
    hit_tokens: int = 0
    miss_tokens: int = 0
    inserted_blocks: int = 0
    evictions: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Node:
    __slots__ = ("key", "block", "parent", "children", "refs")

    def __init__(self, key: tuple, block: int, parent: "_Node | None") -> None:
        self.key = key          # the block_tokens ids this node spans
        self.block = block      # device pool block id (-1 on the root)
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.refs = 0


@dataclass
class Match:
    """A pinned chain of matched blocks. ``blocks`` are pool ids in prefix
    order; ``tokens`` == len(blocks) * block_tokens. Hold it across the
    device gather, then :meth:`RadixIndex.release` it exactly once."""

    blocks: list[int] = field(default_factory=list)
    tokens: int = 0
    nodes: list = field(default_factory=list, repr=False)
    released: bool = False


class RadixIndex:
    def __init__(self, num_blocks: int, block_tokens: int) -> None:
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.stats = CacheStats()               # guarded by: _lock
        self._root = _Node((), -1, None)        # guarded by: _lock
        # pop() -> 0 first
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))  # guarded by: _lock
        # LRU queue of evictable nodes (linked leaves with refcount 0) in
        # insertion order: eviction is an O(1) front pop, not a trie scan
        # under the lock
        self._evictable: dict[_Node, None] = {}  # guarded by: _lock
        self._lock = threading.Lock()

    # -- introspection ---------------------------------------------------

    @property
    def blocks_used(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    @property
    def pinned_blocks(self) -> int:
        """Blocks with a live refcount: what an unreleased Match leaks.
        An O(nodes) trie walk, for checks, never on the hot path."""
        with self._lock:
            return self._pinned_locked()

    def _pinned_locked(self) -> int:
        count = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.refs > 0:
                count += 1
            stack.extend(node.children.values())
        return count

    def stats_dict(self) -> dict:
        with self._lock:
            d = self.stats.to_dict()
            d["blocks_used"] = self.num_blocks - len(self._free)
            d["blocks_total"] = self.num_blocks
            d["pinned_blocks"] = self._pinned_locked()
            return d

    # -- matching --------------------------------------------------------

    def _walk_locked(self, tokens: Sequence[Hashable], max_tokens: int) -> list[_Node]:
        BLK = self.block_tokens
        limit = min(len(tokens), max_tokens)
        chain: list[_Node] = []
        node = self._root
        off = 0
        while off + BLK <= limit:
            child = node.children.get(tuple(tokens[off : off + BLK]))
            if child is None:
                break
            chain.append(child)
            node = child
            off += BLK
        return chain

    def match(self, tokens: Sequence[Hashable], max_tokens: int | None = None) -> Match:
        """Longest block-aligned cached prefix of ``tokens``, PINNED: every
        matched node's refcount is bumped so eviction cannot reallocate its
        block before :meth:`release`. ``max_tokens`` caps the match (the
        engine passes len - 1, so one suffix token is left to give the
        first token's logits)."""
        if max_tokens is None:
            max_tokens = len(tokens)
        with self._lock:
            chain = self._walk_locked(tokens, max_tokens)
            for n in chain:
                n.refs += 1
                self._evictable.pop(n, None)  # pinned: off the LRU queue
            matched = len(chain) * self.block_tokens
            self.stats.lookups += 1
            self.stats.hit_tokens += matched
            self.stats.miss_tokens += max(len(tokens) - matched, 0)
            return Match(blocks=[n.block for n in chain], tokens=matched, nodes=chain)

    def probe(self, tokens: Sequence[Hashable], max_tokens: int | None = None) -> int:
        """Read-only match length in tokens, safe from other threads. No
        pin, no stats, no LRU touch."""
        if max_tokens is None:
            max_tokens = len(tokens)
        with self._lock:
            return len(self._walk_locked(tokens, max_tokens)) * self.block_tokens

    def release(self, match: Match) -> None:
        with self._lock:
            if match.released:
                return
            match.released = True
            for n in match.nodes:
                n.refs -= 1
                self._refresh_evictable_locked(n)

    # -- insertion / eviction -------------------------------------------

    def _refresh_evictable_locked(self, node: _Node) -> None:
        """Re-derive a node's LRU-queue membership after a refs or children
        change: linked leaves with refcount 0 sit in the queue, moved to the
        MRU end on refresh (a parent exposed by a tail eviction re-enters at
        the MRU end too: an approximation that only delays its turn)."""
        self._evictable.pop(node, None)
        if node.parent is not None and node.refs == 0 and not node.children:
            self._evictable[node] = None

    def _evict_one_locked(self) -> int | None:
        """Reclaim the LRU unpinned LEAF's block; None when everything is
        pinned or interior (chains are evicted tail-first)."""
        victim = next(iter(self._evictable), None)
        if victim is None:
            return None
        del self._evictable[victim]
        parent = victim.parent
        parent.children.pop(victim.key, None)
        victim.parent = None  # unlinked: a late refresh can never re-queue it
        self.stats.evictions += 1
        # the unlink may expose the parent as a new evictable leaf
        self._refresh_evictable_locked(parent)
        return victim.block

    def insert(self, tokens: Sequence[Hashable], upto: int) -> list[tuple[int, int]]:
        """Extend the trie to cover ``tokens[:upto]`` (block-truncated),
        reusing existing nodes; allocates pool blocks for the missing tail,
        evicting LRU leaves as needed. Returns [(block_id, token_offset)]
        for NEWLY allocated blocks only: the caller fills those pool blocks
        before the next match can hand them out. Stops early (possibly
        empty) when nothing is evictable."""
        BLK = self.block_tokens
        limit = min(len(tokens), upto) // BLK * BLK
        new: list[tuple[int, int]] = []
        path: list[_Node] = []
        with self._lock:
            node = self._root
            off = 0
            while off + BLK <= limit:
                key = tuple(tokens[off : off + BLK])
                child = node.children.get(key)
                if child is None:
                    block = self._free.pop() if self._free else self._evict_one_locked()
                    if block is None:
                        break
                    child = _Node(key, block, node)
                    node.children[key] = child
                    self._evictable.pop(node, None)  # the parent is no leaf now
                    self.stats.inserted_blocks += 1
                    new.append((block, off))
                # transient pin: a later allocation in THIS insert must not
                # evict a node of the chain being built
                child.refs += 1
                self._evictable.pop(child, None)
                path.append(child)
                node = child
                off += BLK
            for n in path:
                n.refs -= 1
                self._refresh_evictable_locked(n)
        return new
