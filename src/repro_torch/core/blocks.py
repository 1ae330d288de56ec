"""Efficient block management (§4.3).

Pure accounting layer shared by the simulator and the real engine: tracks,
per request, how many KV blocks live on DEVICE vs HOST, drives the paper's
three mechanisms, and exposes the copy-budget decision procedure:

* **Eviction policy** — under memory pressure evict blocks of requests near
  the tail of the sorted queue (they will not run soon), sparing requests
  close to the starvation threshold.
* **Asynchronous offloading** — blocks are proactively mirrored device→host
  every ``n_off`` newly generated blocks (priority-aware: lower priority ⇒
  smaller threshold ⇒ more eagerly mirrored, because it is more likely to be
  preempted).  At eviction time, mirrored blocks are freed instantly; blocks
  not yet mirrored are *dropped* (pending transfer discarded) and their
  tokens must later be recomputed — exactly the paper's "directly evict all
  its device blocks and discard the pending transfer".
* **Pipelined reloading + adaptive copy-budget control** — ``copy_budget``
  implements the 3-case decision procedure (T_fwd_min vs t_budget vs
  T_trans_max, with the binary search of case 2(ii)), and
  ``plan_reload`` implements the per-request full/partial-copy admission
  rule with the β effective-progress threshold.

Token-resident layout per request is always a CONTIGUOUS PREFIX:
``[0, dev_tokens)`` on device, ``[dev_tokens, dev_tokens+host_tokens)`` on
host; anything beyond was dropped and must be recomputed (it is ordinary
chunked-prefill work — prompt and generated tokens are all known).

**Prefix-cache accounting.**  With a radix prefix cache attached (see
``serving/prefix_cache.py`` / the sim cache in ``core/prefix.py``), every
device block is charged exactly once: blocks uniquely owned by a request
count in ``used_blocks``; blocks referenced by the cache (shared by any
number of requests) count in ``cache_charge``.  A request tracks how many
of its table blocks are cache-charged in ``ReqBlocks.shared_blocks`` so
release/evict free only the uniquely-owned remainder.  Cache-held blocks
are reclaimed on demand (``cache.reclaim``) before any request is evicted
— shared blocks are pinned while in use, so §4.3 offload/evict only ever
frees uniquely-owned blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

from .estimator import COLD_WIRE_RATIO
from .request import Request


class PrefixCacheHandle(Protocol):
    """What the BlockManager needs to know about an attached prefix cache."""

    def reclaim(self, need_blocks: int) -> int:
        """Evict unpinned cache entries until ``need_blocks`` are freed (or
        nothing evictable remains); returns blocks actually freed."""
        ...

    def detach(self, rid: int) -> None:
        """Unpin every cache node ``rid`` was holding."""
        ...


def blocks_for(tokens: int, block_size: int) -> int:
    return (tokens + block_size - 1) // block_size


@dataclass
class ReqBlocks:
    """Per-request block residency (token granularity, prefix-contiguous)."""
    dev_tokens: int = 0     # contiguous prefix resident on device
    host_tokens: int = 0    # next contiguous span resident on host
    mirrored_blocks: int = 0  # device blocks already mirrored to host (async offload)
    pending_offload: int = 0  # blocks queued on the D2H lane, not yet complete
    restore_pending: int = 0  # blocks apply_reload promised device-resident
    # whose DATA still sits on host — the engine's H2D copy order.  (With
    # async mirroring the host dict alone can't signal this: mirrored
    # blocks of a live device-resident request also appear there.)
    shared_blocks: int = 0  # table blocks charged to the prefix cache, not
    # to used_blocks (cache-referenced; possibly shared with other requests)
    cold_tokens: int = 0    # host span demoted to the int8 cold tier; the
    # tier demotes WHOLE groups, so this is 0 or == host_tokens, and a
    # reload of a cold group crosses the wire at COLD_WIRE_RATIO width

    def computed_tokens(self) -> int:
        return self.dev_tokens + self.host_tokens


@dataclass
class TransferLane:
    """Models one copy direction (D2H or H2D) with finite bandwidth.

    ``busy_until`` advances as copies are enqueued; copies overlap compute
    (separate stream, App. B) but the lane itself is serial.
    """
    t_block: float                    # seconds per block
    busy_until: float = 0.0
    total_blocks: int = 0

    def enqueue(self, now: float, n_blocks: int,
                wire_scale: float = 1.0) -> float:
        """Schedule n blocks; returns completion time.  ``wire_scale``
        shrinks the occupancy of narrow-wire copies (cold-tier int8
        blocks at COLD_WIRE_RATIO); the default 1.0 is exact — x*1.0 is
        bitwise x — so legacy callers are unchanged."""
        start = max(now, self.busy_until)
        self.busy_until = start + n_blocks * self.t_block * wire_scale
        self.total_blocks += n_blocks
        return self.busy_until


@dataclass
class CopyPlan:
    """Per-request reload decision for the coming batch."""
    restore_blocks: int = 0     # host blocks copied back H2D this round
    drop_host_tokens: int = 0   # host tokens abandoned (will be recomputed)
    admitted: bool = True       # False ⇒ skip request this round (Alg.1 l.19)


class BlockManager:
    """Device block pool + host pool + the §4.3 mechanisms."""

    def __init__(self, num_device_blocks: int, block_size: int,
                 t_block: float, *, async_offload: bool = True,
                 adaptive_copy: bool = True, recompute_only: bool = False,
                 n_off_by_priority: Optional[dict[int, int]] = None,
                 beta: float = 1.5, t_block_alpha: float = 0.25,
                 host_budget_blocks: Optional[int] = None):
        self.num_device_blocks = num_device_blocks
        self.block_size = block_size
        self.t_block = t_block
        self.async_offload = async_offload
        self.adaptive_copy = adaptive_copy
        self.recompute_only = recompute_only  # "Recompute" ablation: drop on evict
        self.beta = beta
        # priority -> offload threshold (new blocks between proactive mirrors);
        # lower priority (larger int) gets a SMALLER threshold.
        self.n_off_by_priority = n_off_by_priority or {1: 8, 2: 4, 3: 2}
        self.d2h = TransferLane(t_block)
        self.h2d = TransferLane(t_block)
        self.table: dict[int, ReqBlocks] = {}
        self.used_blocks = 0
        # optional radix prefix cache (real or simulated); blocks it holds
        # are charged here so free_blocks stays truthful for admission.
        self.cache: Optional[PrefixCacheHandle] = None
        self.cache_charge = 0
        # --- real transfer lanes (§4.3 closed loop) -----------------------
        # With ``external_lanes`` an engine-owned background worker performs
        # the actual copies: proactive-offload directives are forwarded to
        # ``offload_sink(rid, start_block, n_blocks)`` and mirrored blocks
        # advance only on ``note_offload_complete`` (real completions), not
        # on the virtual lane clock.  ``observe_transfer`` feeds measured
        # copy throughput back into ``t_block`` so the adaptive copy budget
        # tracks the hardware instead of a configured constant.
        self.external_lanes = False
        self.offload_sink: Optional[callable] = None
        self.t_block_alpha = t_block_alpha
        # --- host-tier byte budget (simulator mirror of KVTierStore) -----
        # With a budget, evicted-to-host spans beyond it demote LRU whole
        # groups to the int8 cold tier (cold_tokens): reloads then cross
        # the wire at COLD_WIRE_RATIO width.  None = unbounded host tier
        # (legacy).  The real engine drives residency from the actual
        # KVTierStore instead and leaves this None.
        self.host_budget_blocks = host_budget_blocks
        self._host_touch: dict[int, int] = {}
        self._host_clock = 0

    def _touch_host(self, rid: int) -> None:
        self._host_clock += 1
        self._host_touch[rid] = self._host_clock

    def _enforce_host_budget(self) -> None:
        """Demote LRU hot host groups to cold until the hot span fits the
        budget (mirrors ``KVTierStore._enforce``; whole groups only)."""
        if self.host_budget_blocks is None:
            return
        while True:
            hot = [(rid, s) for rid, s in self.table.items()
                   if s.host_tokens and not s.cold_tokens]
            over = (sum(blocks_for(s.host_tokens, self.block_size)
                        for _, s in hot) - self.host_budget_blocks)
            if over <= 0 or not hot:
                return
            victim = min(hot, key=lambda e: self._host_touch.get(e[0], 0))
            victim[1].cold_tokens = victim[1].host_tokens

    # ------------------------------------------------------------------
    def state(self, req: Request) -> ReqBlocks:
        return self.table.setdefault(req.rid, ReqBlocks())

    @property
    def free_blocks(self) -> int:
        return self.num_device_blocks - self.used_blocks - self.cache_charge

    def dev_blocks(self, req: Request) -> int:
        return blocks_for(self.state(req).dev_tokens, self.block_size)

    def blocks_needed_for_growth(self, req: Request, new_tokens: int) -> int:
        s = self.state(req)
        return (blocks_for(s.dev_tokens + new_tokens, self.block_size)
                - blocks_for(s.dev_tokens, self.block_size))

    # --- prefix-cache hooks ----------------------------------------------
    def reclaim_cache(self, need_blocks: int) -> int:
        """Ask the attached cache to free unpinned blocks (LRU/priority)."""
        if self.cache is None or need_blocks <= 0:
            return 0
        return self.cache.reclaim(need_blocks)

    def charge_cache(self, n_blocks: int) -> None:
        self.cache_charge += n_blocks

    def discharge_cache(self, n_blocks: int) -> None:
        self.cache_charge -= n_blocks

    def attach_cached(self, req: Request, tokens: int) -> None:
        """Admission-time prefix-cache hit: the first ``tokens`` (block
        aligned) are already resident in cache-charged blocks — the request
        references them without owning them."""
        s = self.state(req)
        assert s.dev_tokens == 0 and s.host_tokens == 0, \
            "attach_cached requires a fresh request"
        s.dev_tokens = tokens
        s.shared_blocks = tokens // self.block_size

    def donate_to_cache(self, req: Request, n_blocks: int) -> None:
        """The cache adopted ``n_blocks`` of req's uniquely-owned blocks
        (prompt insertion): transfer their charge request -> cache."""
        s = self.state(req)
        self.used_blocks -= n_blocks
        self.cache_charge += n_blocks
        s.shared_blocks += n_blocks

    def note_fork(self, req: Request) -> None:
        """A copy-on-write fork replaced one of req's shared blocks with a
        private copy: the new block is request-owned."""
        s = self.state(req)
        s.shared_blocks -= 1
        self.used_blocks += 1

    # --- growth / release ------------------------------------------------
    def grow(self, req: Request, new_tokens: int, now: float) -> bool:
        """Account for new KV written on device; triggers async offload."""
        need = self.blocks_needed_for_growth(req, new_tokens)
        if need > self.free_blocks:
            self.reclaim_cache(need - self.free_blocks)
        if need > self.free_blocks:
            return False
        s = self.state(req)
        s.dev_tokens += new_tokens
        self.used_blocks += need
        if self.async_offload and not self.recompute_only:
            self._maybe_offload(req, now)
        return True

    def _maybe_offload(self, req: Request, now: float) -> None:
        """Proactive D2H mirroring every ``n_off`` new FULL blocks (§4.3)."""
        s = self.state(req)
        n_off = self.n_off_by_priority.get(
            req.priority, max(self.n_off_by_priority.values()))
        full = s.dev_tokens // self.block_size        # only full blocks mirror
        unmirrored = full - s.mirrored_blocks - s.pending_offload
        if unmirrored >= n_off:
            start = s.mirrored_blocks + s.pending_offload
            if self.external_lanes and self.offload_sink is not None:
                self.offload_sink(req.rid, start, unmirrored)
            else:
                self.d2h.enqueue(now, unmirrored)
            s.pending_offload += unmirrored

    def complete_offloads(self, now: float) -> None:
        """Advance the D2H lane: anything enqueued before ``now`` is durable.

        With ``external_lanes`` this is a no-op — real transfer completions
        arrive via ``note_offload_complete`` instead of a virtual clock."""
        if self.external_lanes:
            return
        for s in self.table.values():
            if s.pending_offload and self.d2h.busy_until <= now:
                s.mirrored_blocks += s.pending_offload
                s.pending_offload = 0

    def note_offload_complete(self, rid: int, n_blocks: int) -> None:
        """A real D2H transfer of ``n_blocks`` landed on host (engine
        transfer-worker completion callback)."""
        s = self.table.get(rid)
        if s is None:
            return
        take = min(n_blocks, s.pending_offload)
        s.pending_offload -= take
        s.mirrored_blocks = min(s.mirrored_blocks + take,
                                s.dev_tokens // self.block_size)

    def note_offload_failed(self, rid: int, n_blocks: int) -> None:
        """A real D2H transfer failed: release its pending-offload claim so
        proactive mirroring can retry (the blocks stay unmirrored)."""
        s = self.table.get(rid)
        if s is None:
            return
        s.pending_offload = max(0, s.pending_offload - n_blocks)

    def observe_transfer(self, n_blocks: int, seconds: float) -> None:
        """Close the §4.3 control loop: fold a measured copy into the
        per-block transfer-time estimate the copy budget is computed from."""
        if n_blocks <= 0 or seconds <= 0:
            return
        sample = seconds / n_blocks
        a = self.t_block_alpha
        self.t_block = (1.0 - a) * self.t_block + a * sample
        self.d2h.t_block = self.h2d.t_block = self.t_block

    def release(self, req: Request) -> None:
        """Request finished: free its uniquely-owned device + host
        residency; cache-charged (shared) blocks stay with the cache."""
        s = self.table.pop(req.rid, None)
        if s is not None:
            self.used_blocks -= (blocks_for(s.dev_tokens, self.block_size)
                                 - s.shared_blocks)
        if self.cache is not None:
            # unconditional: a request can hold cache pins with zero
            # shared_blocks (its insert found the path already present)
            self.cache.detach(req.rid)

    # --- eviction ----------------------------------------------------------
    def evict(self, req: Request, now: float) -> int:
        """Evict ALL device blocks of ``req`` (preemption). Returns freed count.

        Mirrored blocks transition to host residency instantly (they were
        proactively copied); unmirrored blocks are dropped — with
        ``recompute_only`` everything is dropped.  Without async offload the
        un-mirrored blocks must be copied synchronously (D2H lane stall).
        """
        s = self.state(req)
        nblocks = blocks_for(s.dev_tokens, self.block_size)
        if nblocks == 0 and s.dev_tokens == 0:
            return 0
        freed = nblocks - s.shared_blocks   # shared blocks stay in the cache
        self.complete_offloads(now)
        if self.recompute_only:
            saved_tokens = 0
        elif self.async_offload:
            saved_tokens = min(s.mirrored_blocks * self.block_size, s.dev_tokens)
            s.pending_offload = 0   # discard in-flight transfers
        else:
            # synchronous offload: copy everything now (stalls the engine;
            # callers account d2h.busy_until - now as eviction latency)
            self.d2h.enqueue(now, nblocks)
            saved_tokens = s.dev_tokens
        # Residency must stay a contiguous prefix to be usable.  If only a
        # prefix of the device span was mirrored, the gap between it and any
        # pre-existing host suffix makes that suffix unusable — drop it.
        if saved_tokens >= s.dev_tokens:
            s.host_tokens = s.dev_tokens + s.host_tokens   # no gap
        else:
            s.host_tokens = saved_tokens                    # gap: suffix dropped
        s.dev_tokens = 0
        s.mirrored_blocks = 0
        s.restore_pending = 0   # nothing device-resident left to materialize
        s.cold_tokens = 0       # fresh eviction lands hot; budget may demote
        self._touch_host(req.rid)
        self._enforce_host_budget()
        self.used_blocks -= freed
        s.shared_blocks = 0
        if self.cache is not None:
            self.cache.detach(req.rid)
        return freed

    # --- adaptive copy-budget control (§4.3) --------------------------------
    def copy_budget(self, t_fwd_min: float, t_trans_max: float,
                    t_budget: float, b_missing: int,
                    t_block_eff: Optional[float] = None) -> int:
        """B_copy by the paper's 3-case procedure.

        ``t_block_eff`` is the tier-aware mean per-block transfer time of
        the missing set (cold int8 blocks cross the wire at
        COLD_WIRE_RATIO width); callers pass it ONLY when cold blocks
        are present, so the all-hot path stays bitwise-legacy on
        ``self.t_block``."""
        if not self.adaptive_copy:
            return b_missing          # "w/o dynamic": always copy everything
        if self.t_block <= 0:
            return b_missing
        tb = self.t_block if t_block_eff is None else t_block_eff
        if t_fwd_min > t_budget:
            # batch time is pinned at the latency budget: hide copies under it
            return int(t_budget // tb)
        if t_fwd_min >= t_trans_max:
            return b_missing          # compute dominates: copy all, fully hidden
        # case 2(ii): binary-search largest B_copy whose transfer time still
        # fits under the (B_copy-dependent) estimated batch latency.  More
        # copies ⇒ less recompute ⇒ forward latency falls toward t_fwd_min,
        # while transfer time rises toward t_trans_max (both monotone).
        lo, hi = 0, b_missing
        while lo < hi:
            mid = (lo + hi + 1) // 2
            trans = mid * tb
            recompute = (b_missing - mid) * self.t_block  # conservative proxy:
            # recomputing a dropped block costs at least its copy time on TPU
            # (prefill of s_blk tokens vs 32GB/s PCIe copy) — refined by the
            # engine which passes estimator-based t_fwd_min.
            fwd = t_fwd_min + recompute
            if trans <= fwd:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def plan_reload(self, req: Request, budget_blocks: int,
                    chunk_cap_tokens: int, remaining_tokens: int) -> CopyPlan:
        """Per-request full/partial copy rule ("Put it Together", §4.3).

        If the remaining copy budget covers all of the request's missing
        (host) blocks, restore them all.  Otherwise consider PARTIAL copy:
        restore ``budget_blocks`` and abandon the rest, whose tokens will be
        recomputed as ordinary chunked prefill.  Partial copy is admitted
        only when it yields enough effective progress this round — either
        ``l_comp`` reaches the round's computable-token cap, or
        ``l_comp / dropped_tokens > beta`` (β > 1); otherwise the request is
        skipped this round and waits for more budget.

        ``chunk_cap_tokens``: max tokens r may compute this round (from the
        residual latency budget).  ``remaining_tokens``: total compute left
        for r assuming the dropped span is recomputed (dropped + new work).
        """
        s = self.state(req)
        miss = blocks_for(s.host_tokens, self.block_size)
        if miss == 0:
            return CopyPlan()
        if budget_blocks >= miss:
            return CopyPlan(restore_blocks=miss)
        restore = max(0, budget_blocks)
        dropped_tokens = max(0, s.host_tokens - restore * self.block_size)
        l_comp = min(chunk_cap_tokens, dropped_tokens + remaining_tokens)
        reaches_cap = l_comp >= chunk_cap_tokens
        ratio = l_comp / max(dropped_tokens, 1)
        if reaches_cap or ratio > self.beta:
            return CopyPlan(restore_blocks=restore,
                            drop_host_tokens=dropped_tokens)
        return CopyPlan(admitted=False)

    def apply_reload(self, req: Request, plan: CopyPlan, now: float) -> float:
        """Execute a reload plan. Returns H2D completion time (pipelined —
        overlapped with forward compute; caller enforces the copy-budget
        guarantee that it fits under batch latency)."""
        if plan.restore_blocks == 0 and plan.drop_host_tokens == 0:
            return now
        s = self.state(req)
        restore_tokens = min(plan.restore_blocks * self.block_size,
                             s.host_tokens)
        need = (blocks_for(s.dev_tokens + restore_tokens, self.block_size)
                - blocks_for(s.dev_tokens, self.block_size))
        self.used_blocks += need
        s.dev_tokens += restore_tokens
        s.host_tokens -= restore_tokens
        s.restore_pending += need   # engine: copy these blocks H2D
        # cold groups ride the int8 wire: same block count, ~4x fewer
        # bytes, so the lane is occupied for COLD_WIRE_RATIO of the time.
        # The hot path keeps the exact legacy enqueue (wire_scale 1.0).
        if s.cold_tokens > 0:
            done = self.h2d.enqueue(now, plan.restore_blocks,
                                    COLD_WIRE_RATIO)
        else:
            done = self.h2d.enqueue(now, plan.restore_blocks)
        if plan.drop_host_tokens:
            s.host_tokens = max(0, s.host_tokens - plan.drop_host_tokens)
        if s.cold_tokens:
            # whole-group tiers: what remains on host stays cold
            s.cold_tokens = s.host_tokens
        self._touch_host(req.rid)
        return done
