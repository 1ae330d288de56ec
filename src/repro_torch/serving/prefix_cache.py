"""Radix-tree prefix cache over the paged KV store (port of
``repro.serving.prefix_cache``).

Matches incoming prompts against cached prefixes at BLOCK granularity
(token-aligned to ``block_size``): a hit lets the request point its block
table at the cached physical blocks (``PagedKVPool.share`` — reference
counted, copy-on-write on any later write into a shared block) and charges
only the uncached suffix to chunked prefill.

Structure: a compressed radix tree whose edges are runs of full token
blocks.  Each node stores the token content of its run (one tuple per
block) and the physical device blocks holding that run's KV.  Divergence
inside a node splits it at the block boundary (the standard radix split),
so every cached block is owned by exactly one node.

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

**Tiered spill (``spill=True``).**  Instead of destroying an evicted
node's KV, reclaim SPILLS it into the pool's ``KVTierStore`` under a
fresh negative pseudo-rid: the node stays in the tree with
``blocks == []`` and ``host_rid`` set, its device blocks are freed, and
its data rides the host tier's LRU (demoting to the int8 cold tier under
byte pressure).  A later ``match`` walking onto a spilled node RESTORES
it — preferring a buffer the transfer worker pre-staged through the
double-buffered H2D lane, else one synchronous batched scatter — and a
later ``insert`` whose prompt covers the node RE-ADOPTS the inserting
request's freshly prefilled device blocks directly (no copy at all),
dropping the host copy.  Spilled subtrees count zero device blocks, so
``max_blocks`` keeps bounding HBM while the tier bounds host bytes.
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
    host_rid: Optional[int] = None  # tier pseudo-rid when spilled (blocks=[])


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0
    inserted_blocks: int = 0
    evicted_blocks: int = 0
    spilled_blocks: int = 0    # blocks parked in the host tier on eviction
    restored_blocks: int = 0   # spilled blocks reloaded to device on match
    readopted_blocks: int = 0  # spilled blocks re-adopted from an insert
    staged_restores: int = 0   # restores served from pre-staged H2D buffers


class RadixPrefixCache:
    """One engine replica's prefix cache (not thread-safe by itself: the
    engine touches it only from the thread that steps it, like the pool)."""

    def __init__(self, pool: PagedKVPool, bm: BlockManager,
                 max_blocks: Optional[int] = None,
                 priority_bonus: float = 30.0, spill: bool = False):
        self.pool = pool
        self.bm = bm
        self.block_size = pool.block_size
        self.max_blocks = (pool.num_blocks // 2 if max_blocks is None
                           else max_blocks)
        self.priority_bonus = priority_bonus
        self.spill = spill                   # evictions park in the tier
        self.worker = None                   # optional TransferWorker (H2D
        #                                      staging for spill restores)
        self.root = _Node(key=[], blocks=[])
        self._locks: dict[int, set] = {}     # rid -> pinned nodes
        self._spilled: dict[int, _Node] = {}  # host pseudo-rid -> node
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
        if node.host_rid is not None:
            # splitting a SPILLED node: partition its tier group so both
            # halves stay independently reloadable.  Any buffer the worker
            # already staged for the old pseudo-rid remains valid for the
            # upper half (adopt takes the first ``at`` blocks).
            lower_host = self.pool.new_cache_rid()
            self.pool.tier.split_group(node.host_rid, at, lower_host)
            lower.host_rid = lower_host
            self._spilled[lower_host] = lower
        # pinning rids now hold both halves
        for rid in node.pins:
            self._locks[rid].add(lower)
        return node

    def _walk(self, chunks: list[tuple], on_spilled=None
              ) -> tuple[int, list[int], list[_Node]]:
        """Longest existing path matching ``chunks``, splitting the last
        node if the match ends inside it, so the match always ends at a
        node boundary.  Returns (blocks matched, physical blocks, path).

        Walking onto a SPILLED node calls ``on_spilled(node, i, path)``,
        which must bring the node's blocks back on device (restore or
        re-adopt) and return True — returning False (or no callback)
        stops the walk before the spilled node."""
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
            if child.host_rid is not None:
                if on_spilled is None or not on_spilled(child, i, path):
                    break
            blocks += child.blocks
            path.append(child)
            i += j
            node = child
        return i, blocks, path

    # --- engine surface -------------------------------------------------
    def match(self, tokens: np.ndarray, now: float, rid: int,
              weight: float = 1.0) -> tuple[int, list[int]]:
        """Longest cached prefix usable by ``tokens``; pins the path for
        ``rid``.  Returns (cached tokens, physical blocks to share).
        Spilled nodes on the path are restored from the host tier."""
        usable = (len(tokens) - 1) // self.block_size
        chunks = self._chunks(tokens, usable)

        def restore(child, i, path):
            return self._restore_node(child, path)

        n, blocks, path = self._walk(chunks, on_spilled=restore)
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
        ``table`` with a new pool reference.  A SPILLED node covered by
        the prompt is RE-ADOPTED from the request's freshly prefilled
        device blocks (no copy — the host tier's copy is dropped).
        Returns adopted block count (the caller transfers their charge
        via ``donate_to_cache``)."""
        nb = len(tokens) // self.block_size
        chunks = self._chunks(tokens, nb)
        adopted = 0

        def readopt(child, i, path):
            nonlocal adopted
            n = len(child.key)
            child.blocks = [table[i + k] for k in range(n)]
            for b in child.blocks:
                self.pool.incref(b)
            self._forget_spill(child)
            adopted += n
            self.stats.readopted_blocks += n
            return True

        i, _, path = self._walk(chunks, on_spilled=readopt)
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
        """Evict unpinned device-holding nodes (LRU, priority-weighted)
        until ``need_blocks`` freed or nothing evictable remains.  With
        ``spill`` the victim's KV is parked in the host tier (node stays
        in-tree, restorable); otherwise it is destroyed.  ``protect`` is
        a set of node ids that must not be touched (the match path of an
        in-progress restore)."""
        freed = 0
        skip: set[int] = set(protect or ())
        while freed < need_blocks:
            victim = self._evictable_leaf(skip)
            if victim is None:
                break
            n = len(victim.blocks)
            if self.spill:
                host_rid = self.pool.new_cache_rid()
                # gather (device copy) BEFORE the decrefs free the blocks
                self.pool.spill_cache_blocks(host_rid, victim.blocks)
                victim.host_rid = host_rid
                self._spilled[host_rid] = victim
                self.stats.spilled_blocks += n
            for b in victim.blocks:
                self.pool.decref(b)
            if self.spill:
                victim.blocks = []
            else:
                victim.parent.children.pop(victim.key[0], None)
            freed += n
        if freed:
            self.bm.discharge_cache(freed)
            self.stats.evicted_blocks += freed
        return freed

    def _evictable_leaf(self, skip: set) -> Optional[_Node]:
        """Cheapest unpinned node holding device blocks with NO device
        blocks below it (spilled descendants don't shield an ancestor) —
        never one whose blocks are still referenced by an in-flight block
        table (refcount > 1): eviction must not free a block with more
        than one reference.  Without spill every node holds device
        blocks, so this reduces to the classic leaf-only rule."""
        best, best_score = None, None

        def scan(nd: _Node) -> bool:
            # returns True iff nd's subtree holds any device blocks
            nonlocal best, best_score
            below = False
            for c in nd.children.values():
                below |= scan(c)
            if (nd.blocks and not below and not nd.pins
                    and id(nd) not in skip):
                if any(self.pool.refcount[b] > 1 for b in nd.blocks):
                    skip.add(id(nd))
                else:
                    score = (nd.last_used
                             + self.priority_bonus * (nd.weight - 1.0))
                    if best is None or score < best_score:
                        best, best_score = nd, score
            return below or bool(nd.blocks)

        for c in self.root.children.values():
            scan(c)
        return best

    # --- tier spill/restore ----------------------------------------------
    def _restore_node(self, node: _Node, path: list[_Node]) -> bool:
        """Bring a spilled node's KV back on device: adopt a buffer the
        transfer worker pre-staged through the H2D lane if one is ready,
        else one synchronous batched reload (evicting colder nodes for
        room if needed).  Returns True on success."""
        host_rid = node.host_rid
        n = len(node.key)
        if self.pool.tier.n_blocks(host_rid) < n:
            # tier lost the payload (invalidated group): prune the stub
            self._drop_spilled_subtree(node)
            return False
        phys: list[int] = []
        if self.worker is not None:
            st = self.worker.take_staged(host_rid, 0)
            if st is not None:
                phys = self.pool.adopt_staged_group(host_rid, st[1], n)
                if phys:
                    self.stats.staged_restores += 1
        if not phys:
            short = n - len(self.pool.free)
            if short > 0:
                self.reclaim(short,
                             protect={id(nd) for nd in path} | {id(node)})
            phys = self.pool.restore_cache_group(host_rid, n)
        if not phys:
            return False        # no room right now; node stays spilled
        node.blocks = phys
        self._forget_spill(node)
        self.bm.charge_cache(n)
        self.stats.restored_blocks += n
        return True

    def _forget_spill(self, node: _Node) -> None:
        """Node's KV is (back) on device: drop its tier group and any
        in-flight/staged worker buffer for the stale pseudo-rid."""
        host_rid = node.host_rid
        node.host_rid = None
        self._spilled.pop(host_rid, None)
        self.pool.tier.drop(host_rid)
        if self.worker is not None:
            self.worker.invalidate(host_rid)

    def _drop_spilled_subtree(self, node: _Node) -> None:
        """Prune a subtree whose spilled payload is gone for good."""
        node.parent.children.pop(node.key[0], None)
        stack = [node]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd.host_rid is not None:
                self._forget_spill(nd)
            if nd.blocks:       # defensive: spilled subtrees hold none
                for b in nd.blocks:
                    self.pool.decref(b)
                self.bm.discharge_cache(len(nd.blocks))
                self.stats.evicted_blocks += len(nd.blocks)

    def has_spilled(self, host_rid: int) -> bool:
        """Does the tree still hold the node for this spill pseudo-rid?
        (The engine's transfer-drain guard uses this to keep staged
        buffers for live spill groups.)"""
        return host_rid in self._spilled

    def spill_candidates(self, limit: int = 2) -> list[tuple]:
        """Most-recently-touched spilled groups as ``(host_rid,
        payloads)`` prefetch hints for the background H2D staging lane."""
        rids = sorted(self._spilled,
                      key=lambda r: self.pool.tier._touch.get(r, 0),
                      reverse=True)
        out = []
        for host_rid in rids[:limit]:
            nd = self._spilled[host_rid]
            payloads = self.pool.tier.payloads(host_rid,
                                               range(len(nd.key)))
            if payloads is not None:
                out.append((host_rid, payloads))
        return out

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

    def hit_rate(self) -> float:
        n = self.stats.hits + self.stats.misses
        return self.stats.hits / n if n else 0.0
