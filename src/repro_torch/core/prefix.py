"""Prefix-identity primitives shared by the router, the simulator and the
real engine (pure Python — no JAX).

Three pieces:

* ``chunk_hashes`` — the rolling per-block hash chain that identifies a
  prompt prefix at block granularity.  Hash ``k`` commits to the first
  ``(k+1) * block_size`` tokens, so two prompts agree on hash ``k`` iff
  they share that whole prefix (modulo hash collisions, which only cost a
  misrouted request — the engine-side radix cache compares real tokens).
* ``PrefixRegistry`` — router-side memory of which replica has prefilled
  which prefix recently.  GoRouting's prefix-affinity term reads it to
  land repeated prefixes on the replica already holding their KV.
* ``SimPrefixCache`` — the simulator's cache model.  Sim requests carry no
  token content, so it matches on the generator-stamped
  ``(prefix_group, shared_prefix_len)`` identity instead of a radix walk;
  capacity / pinning / LRU+priority eviction mirror the real
  ``serving/prefix_cache.RadixPrefixCache`` so simulated hit rates and
  block pressure are faithful.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from .estimator import COLD_WIRE_RATIO
from .request import Request


def usable_prefix(cache_len: int, prompt_len: int, block_size: int) -> int:
    """Largest cached span a prompt can consume: block-aligned, and at
    least one prompt token must stay uncached — the pass that completes
    the prompt produces the first token's logits."""
    return (min(cache_len, prompt_len - 1) // block_size) * block_size


def chunk_hashes(tokens, block_size: int) -> list[int]:
    """Rolling hash chain over full blocks: out[k] identifies tokens
    ``[0, (k+1)*block_size)``."""
    out: list[int] = []
    h = 0
    for i in range(len(tokens) // block_size):
        h = hash((h, tuple(int(t) for t in
                           tokens[i * block_size:(i + 1) * block_size])))
        out.append(h)
    return out


class PrefixRegistry:
    """Per-instance LRU of recently dispatched prefix hash chains.

    ``observe`` is called at dispatch time (optimistic: the replica will
    hold the prefix once it prefills); ``lookup`` returns, per instance,
    the longest prefix (in tokens) the instance plausibly has cached.
    """

    def __init__(self, block_size: int = 16, max_entries: int = 8192):
        self.block_size = block_size
        self.max_entries = max_entries
        # iid -> (chain hash -> cached tokens), LRU-ordered
        self._seen: dict[int, OrderedDict[int, int]] = {}

    def observe(self, iid: int, tokens, chain: Optional[list] = None) -> None:
        d = self._seen.setdefault(iid, OrderedDict())
        bs = self.block_size
        if chain is None:
            chain = chunk_hashes(tokens, bs)
        for k, h in enumerate(chain):
            if d.get(h, 0) < (k + 1) * bs:
                d[h] = (k + 1) * bs
            d.move_to_end(h)
        while len(d) > self.max_entries:
            d.popitem(last=False)

    def lookup(self, tokens, chain: Optional[list] = None) -> dict[int, int]:
        """{iid: cached prefix tokens} for every instance with a hit.
        ``chain`` (a precomputed ``chunk_hashes(tokens, block_size)``) lets
        hot callers hash the prompt once for lookup + observe."""
        if not self._seen:
            return {}
        bs = self.block_size
        if chain is None:
            chain = chunk_hashes(tokens, bs)
        # the rolling chain is prefix-stable: truncating == re-hashing the
        # usable (block-aligned, >=1 token left uncached) slice
        hashes = chain[:usable_prefix(len(tokens), len(tokens), bs) // bs]
        out: dict[int, int] = {}
        for iid, d in self._seen.items():
            for k in range(len(hashes) - 1, -1, -1):
                if hashes[k] in d:
                    out[iid] = (k + 1) * bs
                    break
        return out

    def drop(self, iid: int) -> None:
        self._seen.pop(iid, None)


class _SimEntry:
    __slots__ = ("blocks", "last_used", "weight")

    def __init__(self, blocks: int, now: float, weight: float):
        self.blocks = blocks
        self.last_used = now
        self.weight = weight


class _SimSpilled:
    """A cache entry whose blocks were evicted to the host tier instead of
    destroyed (sim mirror of the real radix cache's spill-on-evict).
    ``cold`` marks entries demoted past the host budget into the int8
    cold tier — their restore crosses the wire at COLD_WIRE_RATIO."""
    __slots__ = ("blocks", "last_used", "weight", "cold")

    def __init__(self, blocks: int, last_used: float, weight: float):
        self.blocks = blocks
        self.last_used = last_used
        self.weight = weight
        self.cold = False


class SimPrefixCache:
    """Group-identity prefix cache for one simulated instance.

    Implements the :class:`~repro.core.blocks.PrefixCacheHandle` protocol
    (``reclaim`` / ``detach``) so the BlockManager can charge and reclaim
    cache blocks, plus the match/insert surface the sim engine drives.
    Eviction is LRU with a priority bonus: an entry whose users carry
    weight ``w`` survives as if it were used ``priority_bonus * (w - 1)``
    seconds more recently.
    """

    def __init__(self, block_size: int, max_blocks: int,
                 priority_bonus: float = 30.0, *, spill: bool = False,
                 host_budget_blocks: Optional[int] = None):
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.priority_bonus = priority_bonus
        # KV tiering mirror (serving/kv_pool.KVTierStore): with ``spill``
        # on, reclaimed entries move to a host tier instead of being
        # destroyed; a ``host_budget_blocks`` cap demotes LRU spilled
        # entries to the int8 cold tier, whose restores occupy the H2D
        # lane for only COLD_WIRE_RATIO of the hot time.
        self.spill = spill
        self.host_budget_blocks = host_budget_blocks
        self.bm = None                       # set by the owning engine
        self.entries: dict[int, _SimEntry] = {}
        self.spilled: dict[int, _SimSpilled] = {}
        self._pins: dict[int, set[int]] = {}      # group -> rids
        self._rid_group: dict[int, int] = {}
        self.hits = 0
        self.hit_tokens = 0
        self.evicted_blocks = 0
        self.spilled_blocks = 0
        self.restored_blocks = 0

    # --- capacity ------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return sum(e.blocks for e in self.entries.values())

    def _usable_blocks(self, req: Request) -> int:
        if req.prefix_group < 0 or req.shared_prefix_len <= 0:
            return 0
        return usable_prefix(req.shared_prefix_len, req.prompt_len,
                             self.block_size) // self.block_size

    # --- engine surface -------------------------------------------------
    def match(self, req: Request, now: float) -> int:
        """Cached tokens usable by ``req`` (0 if its group is cold)."""
        e = self.entries.get(req.prefix_group)
        if e is None and self.spilled.get(req.prefix_group) is not None:
            e = self._restore(req.prefix_group, now)
        if e is None:
            return 0
        n = min(e.blocks, self._usable_blocks(req))
        if n <= 0:
            return 0
        e.last_used = now
        e.weight = max(e.weight, req.weight)
        self.hits += 1
        self.hit_tokens += n * self.block_size
        return n * self.block_size

    def attach(self, rid: int, group: int) -> None:
        """Pin the group's entry while ``rid`` references its blocks."""
        self._pins.setdefault(group, set()).add(rid)
        self._rid_group[rid] = group

    def insert(self, req: Request, now: float) -> int:
        """Adopt the shared span of a just-prefilled request; returns the
        number of newly cache-charged blocks (0 if already cached)."""
        target = self._usable_blocks(req)
        if target <= 0:
            return 0
        e = self.entries.get(req.prefix_group)
        if e is None:
            # re-adoption: the inserting request just recomputed a spilled
            # prefix on device — the host-tier copy is superseded (the real
            # cache re-links the node to the request's table blocks)
            self.spilled.pop(req.prefix_group, None)
            e = self.entries[req.prefix_group] = _SimEntry(0, now, req.weight)
        adopted = max(0, target - e.blocks)
        e.blocks = max(e.blocks, target)
        e.last_used = now
        e.weight = max(e.weight, req.weight)
        self.attach(req.rid, req.prefix_group)
        return adopted

    def peek_tokens(self, req: Request) -> int:
        """Cached tokens usable by ``req`` without touching LRU state.
        Spilled groups count: a match would restore them from the host
        tier, which still beats recomputing the prefix."""
        e = self.entries.get(req.prefix_group) \
            or self.spilled.get(req.prefix_group)
        return 0 if e is None else \
            min(e.blocks, self._usable_blocks(req)) * self.block_size

    # --- PrefixCacheHandle protocol -------------------------------------
    def detach(self, rid: int) -> None:
        g = self._rid_group.pop(rid, None)
        if g is not None:
            pins = self._pins.get(g)
            if pins is not None:
                pins.discard(rid)

    def reclaim(self, need_blocks: int) -> int:
        freed = 0
        while freed < need_blocks:
            victims = [(g, e) for g, e in self.entries.items()
                       if not self._pins.get(g)]
            if not victims:
                break
            g, e = min(victims, key=lambda ge: ge[1].last_used
                       + self.priority_bonus * (ge[1].weight - 1.0))
            freed += e.blocks
            if self.spill:
                # spill-on-evict: the KV moves to the host tier (the real
                # engine's gather + D2H ride the background lane, so no
                # charge here); device blocks free either way.
                self.spilled[g] = _SimSpilled(e.blocks, e.last_used, e.weight)
                self.spilled_blocks += e.blocks
            del self.entries[g]
            self._pins.pop(g, None)
        if freed and self.bm is not None:
            self.bm.discharge_cache(freed)
        self.evicted_blocks += freed
        if self.spill:
            self._enforce_spill_budget()
        return freed

    # --- host-tier spill model (mirror of the real spill-on-evict) ------
    def _enforce_spill_budget(self) -> None:
        """Demote LRU hot spilled entries to the cold tier until the hot
        span fits ``host_budget_blocks`` (None = unbounded hot tier)."""
        if self.host_budget_blocks is None:
            return
        while True:
            hot = [(g, s) for g, s in self.spilled.items() if not s.cold]
            over = (sum(s.blocks for _, s in hot)
                    - self.host_budget_blocks)
            if over <= 0 or not hot:
                return
            _, victim = min(hot, key=lambda gs: gs[1].last_used)
            victim.cold = True

    def _restore(self, group: int, now: float) -> Optional[_SimEntry]:
        """Reload a spilled group's blocks onto the device: free blocks are
        claimed (reclaiming other cache entries if short), the H2D lane is
        charged tier-aware (cold int8 groups at COLD_WIRE_RATIO width),
        and the entry rejoins ``entries``.  Returns None — a plain miss —
        when device space cannot be made; the spilled copy is kept."""
        sp = self.spilled.get(group)
        if sp is None or self.bm is None:
            return None
        need = sp.blocks
        short = need - self.bm.free_blocks
        if short > 0:
            # reclaim only touches device-resident entries, never the
            # spilled dict, so the restoring group is safe from it
            self.reclaim(short)
        if need > self.bm.free_blocks:
            return None
        if sp.cold:
            self.bm.h2d.enqueue(now, need, COLD_WIRE_RATIO)
        else:
            self.bm.h2d.enqueue(now, need)
        self.bm.charge_cache(need)
        del self.spilled[group]
        e = self.entries[group] = _SimEntry(sp.blocks, now, sp.weight)
        self.restored_blocks += need
        return e

    def shrink_to_capacity(self) -> int:
        over = self.cached_blocks - self.max_blocks
        return self.reclaim(over) if over > 0 else 0
