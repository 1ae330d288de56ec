"""Radix-tree prefix cache over the paged KV store (port of
``repro.serving.prefix_cache`` without the tiered spill, i.e. the
reference's ``spill=False`` mode).

Matches incoming prompts against cached prefixes at BLOCK granularity
(token-aligned to ``block_size``): a hit lets the request point its block
table at the cached physical blocks (``PagedKVPool.share`` — reference
counted, copy-on-write on any later write into a shared block) and charges
only the uncached suffix to chunked prefill.

Structure: a compressed radix tree whose edges are runs of full token
blocks.  Each node stores the token content of its run (one tuple per
block) and the physical device blocks holding that run's KV.  Divergence
inside a node splits it at the block boundary, so every cached block is
owned by exactly one node.

Lifecycle / accounting (composes with ``core.blocks.BlockManager``):

* ``match``   — admission: walk the tree, return the longest cached prefix
  usable by the prompt (at least one prompt token is always left uncached
  so the completing pass yields first-token logits), pin the path.
* ``insert``  — first-token time: adopt the request's uniquely-owned full
  prompt blocks into the tree (cache takes a pool reference; the caller
  transfers the block charge with ``BlockManager.donate_to_cache``).
* ``reclaim`` — LRU + priority-weighted eviction of UNPINNED leaves only;
  a shared block is pinned while any live request references it, so §4.3
  offload/evict never touches a block with more than one referent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.blocks import BlockManager
from .kv_pool import PagedKVPool


@dataclass(eq=False)     # identity semantics: nodes live in pin sets
class _Node:
    key: list            # token content, one tuple[int, ...] per block
    blocks: list         # physical block ids, len == len(key)
    children: dict = field(default_factory=dict)  # first-block tuple -> _Node
    parent: Optional["_Node"] = None
    pins: set = field(default_factory=set)        # rids using these blocks
    last_used: float = 0.0
    weight: float = 1.0  # max priority weight of requests that used it


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0
    inserted_blocks: int = 0
    evicted_blocks: int = 0


class RadixPrefixCache:
    """One engine replica's prefix cache (not thread-safe by itself: the
    engine touches it only from the thread that steps it, like the pool)."""

    def __init__(self, pool: PagedKVPool, bm: BlockManager,
                 max_blocks: Optional[int] = None,
                 priority_bonus: float = 30.0):
        self.pool = pool
        self.bm = bm
        self.block_size = pool.block_size
        self.max_blocks = (pool.num_blocks // 2 if max_blocks is None
                           else max_blocks)
        self.priority_bonus = priority_bonus
        self.root = _Node(key=[], blocks=[])
        self._locks: dict[int, set] = {}     # rid -> pinned nodes
        self.stats = CacheStats()
        bm.cache = self

    # ------------------------------------------------------------------
    def _chunks(self, tokens, n_blocks: int) -> list[tuple]:
        bs = self.block_size
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n_blocks)]

    def _split(self, node: _Node, at: int) -> _Node:
        """Split ``node`` after its first ``at`` blocks; returns the upper
        half (which keeps the parent edge)."""
        lower = _Node(key=node.key[at:], blocks=node.blocks[at:],
                      children=node.children, parent=node,
                      pins=set(node.pins), last_used=node.last_used,
                      weight=node.weight)
        for c in lower.children.values():
            c.parent = lower
        node.key = node.key[:at]
        node.blocks = node.blocks[:at]
        node.children = {lower.key[0]: lower}
        # pinning rids now hold both halves
        for rid in node.pins:
            self._locks[rid].add(lower)
        return node

    def _walk(self, chunks: list[tuple]
              ) -> tuple[int, list[int], list[_Node]]:
        """Longest existing path matching ``chunks``, splitting the last
        node if the match ends inside it, so the match always ends at a
        node boundary.  Returns (blocks matched, physical blocks, path)."""
        node, i, blocks, path = self.root, 0, [], []
        while i < len(chunks):
            child = node.children.get(chunks[i])
            if child is None:
                break
            j = 0
            while (j < len(child.key) and i + j < len(chunks)
                   and child.key[j] == chunks[i + j]):
                j += 1
            if j == 0:
                break
            if j < len(child.key):
                child = self._split(child, j)
            blocks += child.blocks
            path.append(child)
            i += j
            node = child
        return i, blocks, path

    # --- engine surface -------------------------------------------------
    def match(self, tokens: np.ndarray, now: float, rid: int,
              weight: float = 1.0) -> tuple[int, list[int]]:
        """Longest cached prefix usable by ``tokens``; pins the path for
        ``rid``.  Returns (cached tokens, physical blocks to share)."""
        usable = (len(tokens) - 1) // self.block_size
        n, blocks, path = self._walk(self._chunks(tokens, usable))
        if n == 0:
            self.stats.misses += 1
            return 0, []
        self._pin(rid, path, now, weight)
        self.stats.hits += 1
        self.stats.hit_tokens += n * self.block_size
        return n * self.block_size, blocks

    def insert(self, tokens: np.ndarray, table: list[int], rid: int,
               now: float, weight: float = 1.0) -> int:
        """Adopt the full-block prefix of a just-prefilled prompt into the
        tree.  Blocks already covered by existing nodes are left alone
        (the tree keeps its copies); the divergent suffix is adopted from
        ``table`` with a new pool reference.  Returns the adopted block
        count (the caller transfers their charge via
        ``donate_to_cache``)."""
        nb = len(tokens) // self.block_size
        chunks = self._chunks(tokens, nb)
        adopted = 0
        i, _, path = self._walk(chunks)
        if i < nb:
            parent = path[-1] if path else self.root
            new = _Node(key=chunks[i:], blocks=list(table[i:nb]),
                        parent=parent, last_used=now, weight=weight)
            parent.children[new.key[0]] = new
            for b in new.blocks:
                self.pool.incref(b)
            adopted += nb - i
            path.append(new)
            self.stats.inserted_blocks += nb - i
        self._pin(rid, path, now, weight)
        return adopted

    def _pin(self, rid: int, path: list[_Node], now: float,
             weight: float) -> None:
        held = self._locks.setdefault(rid, set())
        for nd in path:
            nd.pins.add(rid)
            nd.last_used = now
            nd.weight = max(nd.weight, weight)
            held.add(nd)

    # --- PrefixCacheHandle protocol -------------------------------------
    def detach(self, rid: int) -> None:
        for nd in self._locks.pop(rid, ()):
            nd.pins.discard(rid)

    def reclaim(self, need_blocks: int,
                protect: Optional[set] = None) -> int:
        """Evict unpinned leaves (LRU, priority-weighted) until
        ``need_blocks`` are freed or nothing evictable remains.
        ``protect`` is a set of node ids that must not be touched."""
        freed = 0
        skip: set[int] = set(protect or ())
        while freed < need_blocks:
            victim = self._evictable_leaf(skip)
            if victim is None:
                break
            for b in victim.blocks:
                self.pool.decref(b)
            victim.parent.children.pop(victim.key[0], None)
            freed += len(victim.blocks)
        if freed:
            self.bm.discharge_cache(freed)
            self.stats.evicted_blocks += freed
        return freed

    def _evictable_leaf(self, skip: set) -> Optional[_Node]:
        """Cheapest unpinned leaf — never one whose blocks are still
        referenced by an in-flight block table (refcount > 1): eviction
        must not free a block with more than one reference."""
        best, best_score = None, None

        def scan(nd: _Node) -> None:
            nonlocal best, best_score
            for c in nd.children.values():
                scan(c)
            if (nd.blocks and not nd.children and not nd.pins
                    and id(nd) not in skip):
                if any(self.pool.refcount[b] > 1 for b in nd.blocks):
                    skip.add(id(nd))
                else:
                    score = (nd.last_used
                             + self.priority_bonus * (nd.weight - 1.0))
                    if best is None or score < best_score:
                        best, best_score = nd, score

        for c in self.root.children.values():
            scan(c)
        return best

    def shrink_to_capacity(self) -> int:
        over = self.cached_blocks - self.max_blocks
        return self.reclaim(over) if over > 0 else 0

    # --- introspection ---------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        total, stack = 0, list(self.root.children.values())
        while stack:
            nd = stack.pop()
            total += len(nd.blocks)
            stack.extend(nd.children.values())
        return total
