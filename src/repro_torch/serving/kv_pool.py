"""Paged KV pool: the device-side block store and its tiered host mirror
(port of ``repro.serving.kv_pool``).

Layout: one device tensor ``(L, 2, num_blocks, block_size, Hkv, hd)``
(k=0 / v=1), addressed through per-request block tables.  Where the JAX
pool rebinds a new functional array after every ``.at[].set``, this pool
is updated IN PLACE (``index_put_`` / slice assignment on ``self.kv``);
the tensor object never changes.  A device snapshot for the host
(``gather_blocks``) is therefore a fresh tensor written by the
``block_gather`` kernel, never a view of the pool.

Off-device residency is TIERED (``KVTierStore``): a capacity-bounded HOST
tier of fp32 numpy blocks (the §4.3 asynchronous-offload target) and an
unbounded int8-quantized COLD tier that host-tier evictions demote into
(per-plane scales, ``kernels/kv_quant.py``).  Tier entries are keyed per
request; radix-cache spills use negative pseudo-rids (``new_cache_rid``)
so cache nodes and live requests share one LRU clock.  The int8
quantize / dequantize of the tiers runs on the pool's device (the
kernels on the card, their plain versions on the CPU).

Physical blocks are REFERENCE COUNTED so several block tables (and the
radix prefix cache, ``serving/prefix_cache.py``) can point at the same
device block: ``share`` appends existing blocks to another request's
table, ``fork`` implements copy-on-write for writes into a shared block,
and a block returns to the free list only when its last reference drops.

The pool is DATA only; residency accounting and eviction policy live in
``core.blocks.BlockManager``, shared with the simulator.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from ..models.model import ArchConfig, resolve_device


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class KVTierStore:
    """Two-tier off-device block store with one LRU clock across groups.

    * HOT (host DRAM, fp32): bounded by ``budget_bytes``; ``None`` means
      unbounded, with bitwise-identical streams.
    * COLD (int8 + per-plane fp32 scales when ``cold_quantize``, else raw
      fp32, the exact roundtrip mode): unbounded; host-tier evictions
      demote into it WHOLE GROUPS at a time (a group = all blocks of one
      rid / cache pseudo-rid), so any group lives entirely in one tier.

    Eviction is LRU by last touch (monotonic counter, deterministic):
    puts, reads and reloads touch the group.  Demotion quantizes all of a
    group's blocks in ONE ``kv_block_quantize`` call on ``device``;
    promotion (a new hot put for a demoted rid) dequantizes in one call
    likewise.  ``quantize_calls`` / ``dequantize_calls`` count those
    calls.
    """

    def __init__(self, block_bytes: int, budget_bytes: Optional[int] = None,
                 cold_quantize: bool = True, device="cuda"):
        self.block_bytes = block_bytes
        self.budget_bytes = budget_bytes
        self.cold_quantize = cold_quantize
        self.device = resolve_device(device)
        self.hot: dict[int, dict[int, np.ndarray]] = {}
        # bi -> (int8 vals (L,2,bs,Hkv,hd), fp32 scales (L,2)) | fp32 array
        self.cold: dict[int, dict[int, object]] = {}
        self._touch: dict[int, int] = {}
        self._clock = 0
        self.demoted_blocks = 0     # cumulative hot -> cold demotions
        self.cold_reload_blocks = 0  # cumulative cold blocks dequantized
        self.quantize_calls = 0
        self.dequantize_calls = 0

    # --- byte/blocks accounting ------------------------------------------
    @property
    def hot_blocks(self) -> int:
        return sum(len(d) for d in self.hot.values())

    @property
    def cold_blocks(self) -> int:
        return sum(len(d) for d in self.cold.values())

    @property
    def host_bytes(self) -> int:
        return self.hot_blocks * self.block_bytes

    def touch(self, rid: int) -> None:
        self._clock += 1
        self._touch[rid] = self._clock

    def n_blocks(self, rid: int) -> int:
        return len(self.hot.get(rid, ())) + len(self.cold.get(rid, ()))

    def has_block(self, rid: int, bi: int) -> bool:
        return bi in self.hot.get(rid, ()) or bi in self.cold.get(rid, ())

    def block_ids(self, rid: int) -> Iterator[int]:
        yield from self.hot.get(rid, ())
        yield from self.cold.get(rid, ())

    def is_cold(self, rid: int) -> bool:
        return bool(self.cold.get(rid))

    def cold_block_count(self, rid: int) -> int:
        return len(self.cold.get(rid, ()))

    def prefer_cold(self, n_blocks: int) -> bool:
        """Should a fresh offload of ``n_blocks`` land directly in the
        cold tier (int8 D2H wire)?  Yes when the hot budget cannot take it
        without demoting: the put would be demote-bound anyway, so
        quantizing on device saves ~4x D2H traffic."""
        return (self.budget_bytes is not None and self.cold_quantize
                and self.host_bytes + n_blocks * self.block_bytes
                > self.budget_bytes)

    # --- tier movement ----------------------------------------------------
    def put(self, rid: int, blocks: dict) -> None:
        """Land fp32 blocks in the hot tier (D2H completion / sync
        offload), enforcing the byte budget by LRU whole-group demotion."""
        if not blocks:
            return
        if rid in self.cold:
            self._promote(rid)      # keep the whole group in one tier
        self.hot.setdefault(rid, {}).update(blocks)
        self.touch(rid)
        self._enforce(last=rid)

    def put_cold(self, rid: int, blocks: dict) -> None:
        """Land quantized ``(vals, scales)`` payloads straight in the cold
        tier (the int8 D2H wire of a demote-bound offload)."""
        if not blocks:
            return
        if rid in self.hot:
            self._demote(rid)       # group invariant: one tier per rid
        self.cold.setdefault(rid, {}).update(blocks)
        self.touch(rid)

    def get_block(self, rid: int, bi: int) -> Optional[np.ndarray]:
        """Fetch one block as fp32, dequantizing a cold entry on demand."""
        h = self.hot.get(rid)
        if h is not None and bi in h:
            self.touch(rid)
            return h[bi]
        c = self.cold.get(rid)
        if c is not None and bi in c:
            self.touch(rid)
            entry = c[bi]
            if isinstance(entry, tuple):
                self.cold_reload_blocks += 1
                return self._thaw_batch([entry])[0]
            return entry
        return None

    def payloads(self, rid: int, block_ids: Sequence[int]):
        """Raw wire payloads for the H2D lane: fp32 arrays for hot blocks,
        ``(int8 vals, scales)`` tuples for cold ones (uploaded as int8 and
        dequantized ON DEVICE by the transfer worker).  None if any block
        is absent."""
        out = []
        for bi in block_ids:
            h = self.hot.get(rid)
            if h is not None and bi in h:
                out.append(h[bi])
                continue
            c = self.cold.get(rid)
            if c is None or bi not in c:
                return None
            out.append(c[bi])
        if out:
            self.touch(rid)
        return out

    def drop(self, rid: int) -> None:
        self.hot.pop(rid, None)
        self.cold.pop(rid, None)
        self._touch.pop(rid, None)

    def split_group(self, rid: int, at: int, new_rid: int) -> None:
        """Radix-node split of a spilled group: blocks [at, n) move to
        ``new_rid`` re-keyed from 0 (mirroring node splits in the prefix
        cache, whose spilled halves must stay independently
        reloadable)."""
        moved = False
        for store in (self.hot, self.cold):
            g = store.get(rid)
            if not g:
                continue
            lower = {bi - at: v for bi, v in g.items() if bi >= at}
            if lower:
                store[rid] = {bi: v for bi, v in g.items() if bi < at}
                store.setdefault(new_rid, {}).update(lower)
                moved = True
        if moved:
            self._touch[new_rid] = self._touch.get(rid, 0)

    # --- internals --------------------------------------------------------
    def _to_device(self, arrays: list) -> torch.Tensor:
        return torch.from_numpy(np.stack(arrays)).to(self.device)

    def _thaw_batch(self, entries: list) -> np.ndarray:
        out = ops.kv_block_dequantize(self._to_device([e[0] for e in entries]),
                                      self._to_device([e[1] for e in entries]))
        self.dequantize_calls += 1
        return _host(out)

    def _promote(self, rid: int) -> None:
        entries = self.cold.pop(rid, {})
        if not entries:
            return
        keys = sorted(entries)
        quant = [k for k in keys if isinstance(entries[k], tuple)]
        h = self.hot.setdefault(rid, {})
        if quant:
            deq = self._thaw_batch([entries[k] for k in quant])
            self.cold_reload_blocks += len(quant)
            for i, k in enumerate(quant):
                h[k] = deq[i]
        for k in keys:
            if not isinstance(entries[k], tuple):
                h[k] = entries[k]

    def _demote(self, rid: int) -> None:
        entries = self.hot.pop(rid, {})
        if not entries:
            return
        keys = sorted(entries)
        c = self.cold.setdefault(rid, {})
        if self.cold_quantize:
            vals, scales = ops.kv_block_quantize(
                self._to_device([entries[k] for k in keys]))
            self.quantize_calls += 1
            vals, scales = _host(vals), _host(scales)
            for i, k in enumerate(keys):
                c[k] = (vals[i], scales[i])
        else:
            for k in keys:
                c[k] = entries[k]
        self.demoted_blocks += len(keys)

    def _enforce(self, last: Optional[int] = None) -> None:
        if self.budget_bytes is None:
            return
        while self.host_bytes > self.budget_bytes and self.hot:
            others = [r for r in self.hot if r != last]
            victim = (min(others, key=lambda r: self._touch.get(r, 0))
                      if others else last)
            self._demote(victim)


class _RidBlocks:
    """Mapping view of one rid's tier entries as fp32 blocks (cold entries
    are dequantized on item access)."""

    def __init__(self, tier: KVTierStore, rid: int):
        self._tier = tier
        self._rid = rid

    def __contains__(self, bi) -> bool:
        return self._tier.has_block(self._rid, bi)

    def __iter__(self):
        return self._tier.block_ids(self._rid)

    def __len__(self) -> int:
        return self._tier.n_blocks(self._rid)

    def __getitem__(self, bi) -> np.ndarray:
        got = self._tier.get_block(self._rid, bi)
        if got is None:
            raise KeyError(bi)
        return got

    def get(self, bi, default=None):
        got = self._tier.get_block(self._rid, bi)
        return default if got is None else got

    def keys(self):
        return list(self._tier.block_ids(self._rid))


class _HostView:
    """Dict-like ``pool.host`` facade over the tier store."""

    def __init__(self, tier: KVTierStore):
        self._tier = tier

    def __contains__(self, rid) -> bool:
        return self._tier.n_blocks(rid) > 0

    def __getitem__(self, rid) -> _RidBlocks:
        if self._tier.n_blocks(rid) == 0:
            raise KeyError(rid)
        return _RidBlocks(self._tier, rid)

    def get(self, rid, default=None):
        if self._tier.n_blocks(rid) == 0:
            return default
        return _RidBlocks(self._tier, rid)


class PagedKVPool:
    def __init__(self, cfg: ArchConfig, num_blocks: int, block_size: int,
                 dtype=torch.float32, device="cuda",
                 host_tier_bytes: Optional[int] = None,
                 cold_quantize: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv = torch.zeros(
            (cfg.n_layers, 2, num_blocks, block_size, cfg.n_kv_heads,
             cfg.hd), dtype=dtype, device=self.device)
        self.free: list[int] = list(range(num_blocks - 1, 0, -1))
        # block 0 is reserved as the null page block tables pad with
        self.refcount: list[int] = [0] * num_blocks
        self.refcount[0] = 1                      # null page never freed
        self.tables: dict[int, list[int]] = {}
        # tiered host mirror, keyed rid -> {logical block index -> contents}
        # (host_tier_bytes=None: unbounded fp32, bitwise-identical streams)
        block_bytes = (cfg.n_layers * 2 * block_size * cfg.n_kv_heads
                       * cfg.hd * self.kv.element_size())
        self.tier = KVTierStore(block_bytes, host_tier_bytes, cold_quantize,
                                device=self.device)
        self._cache_rid = -1        # next radix-cache spill pseudo-rid
        # calls of the copy kernels made by the pool itself (the tier store
        # and the transfer worker count their own)
        self.gather_calls = 0
        self.quantize_calls = 0
        self.dequantize_calls = 0

    @property
    def host(self) -> _HostView:
        """Dict-like view of off-device residency (both tiers, as fp32)."""
        return _HostView(self.tier)

    def new_cache_rid(self) -> int:
        """Fresh negative pseudo-rid for a radix-cache spill group (never
        collides with real request ids, shares the tier's LRU clock)."""
        rid, self._cache_rid = self._cache_rid, self._cache_rid - 1
        return rid

    # --- allocation ------------------------------------------------------
    def alloc(self, rid: int, n: int) -> bool:
        if len(self.free) < n:
            return False
        t = self.tables.setdefault(rid, [])
        for _ in range(n):
            b = self.free.pop()
            self.refcount[b] = 1
            t.append(b)
        return True

    def ensure_capacity(self, rid: int, tokens: int) -> bool:
        """Grow rid's table to cover ``tokens`` positions."""
        need = -(-tokens // self.block_size) - len(self.tables.get(rid, []))
        return self.alloc(rid, need) if need > 0 else True

    def release(self, rid: int) -> None:
        for b in self.tables.pop(rid, []):
            self.decref(b)
        self.tier.drop(rid)

    def table_rows(self, rids: list[int], maxp: Optional[int] = None,
                   rows: Optional[int] = None) -> np.ndarray:
        """Padded block-table batch as an int32 host array.  ``rows`` >
        len(rids) appends all-zero rows (the fused decode path pads the
        batch to a shape bucket; zero rows address the null block 0)."""
        maxp = maxp or max(len(self.tables[r]) for r in rids)
        out = np.zeros((rows or len(rids), maxp), np.int32)
        for i, r in enumerate(rids):
            t = self.tables[r]
            out[i, :len(t)] = t
        return out

    def table_array(self, rids: list[int], maxp: Optional[int] = None,
                    rows: Optional[int] = None) -> torch.Tensor:
        """``table_rows`` as an int32 device tensor."""
        return torch.from_numpy(self.table_rows(rids, maxp, rows)).to(
            self.device)

    # --- sharing / copy-on-write -----------------------------------------
    def incref(self, block: int) -> None:
        self.refcount[block] += 1

    def decref(self, block: int) -> None:
        """Drop one reference; the block is freed when none remain."""
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self.free.append(block)

    def share(self, rid: int, blocks: Sequence[int]) -> None:
        """Point rid's table at existing physical ``blocks`` (prefix-cache
        hit): each gains a reference instead of being allocated."""
        t = self.tables.setdefault(rid, [])
        for b in blocks:
            self.incref(b)
            t.append(b)

    def shared_with(self, rid: int) -> int:
        """Blocks in rid's table whose physical block has other referents."""
        return sum(1 for b in self.tables.get(rid, [])
                   if self.refcount[b] > 1)

    def fork(self, rid: int, logical: int) -> int:
        """Copy-on-write: give rid a private copy of logical block
        ``logical`` (one in-place device copy).  Returns the new physical
        block id."""
        t = self.tables[rid]
        old = t[logical]
        if not self.free:
            raise RuntimeError("fork: no free block for copy-on-write")
        new = self.free.pop()
        self.refcount[new] = 1
        self.kv[:, :, new] = self.kv[:, :, old]
        t[logical] = new
        self.decref(old)
        return new

    def ensure_writable(self, rid: int, logical: int) -> bool:
        """CoW guard before writing into rid's ``logical`` block: fork the
        block iff it is physically shared.  Returns True if forked."""
        t = self.tables.get(rid, ())
        if logical >= len(t) or self.refcount[t[logical]] <= 1:
            return False
        self.fork(rid, logical)
        return True

    # --- host offload / reload (§4.3 mechanism) ---------------------------
    def _scatter(self, phys: Sequence[int], data: torch.Tensor) -> None:
        """Write (n, L, 2, bs, Hkv, hd) ``data`` into physical blocks
        ``phys`` in one in-place scatter."""
        idx = torch.as_tensor(list(phys), dtype=torch.long,
                              device=self.device)
        self.kv[:, :, idx] = data.to(self.device).movedim(0, 2)

    def _gather(self, phys: Sequence[int]) -> torch.Tensor:
        self.gather_calls += 1
        return ops.block_gather(self.kv, torch.tensor(phys, dtype=torch.int32),
                                block_dim=2)

    def gather_blocks(self, rid: int, block_indices: list[int]):
        """Device-side snapshot of rid's logical blocks, shaped
        (n, L, 2, bs, Hkv, hd): ONE ``block_gather`` launch into a fresh
        contiguous tensor, so later in-place pool writes (or freeing the
        source blocks) cannot disturb it.  This is what the background
        D2H lane copies."""
        t = self.tables[rid]
        return self._gather([t[bi] for bi in block_indices])

    def gather_blocks_quantized(self, rid: int, block_indices: list[int]):
        """Device-side snapshot of rid's logical blocks QUANTIZED on device
        (``kv_block_quantize`` after the gather): the ``(int8 vals, fp32
        scales)`` device pair, the ~4x cheaper D2H wire for offloads that
        will land demote-bound in the cold tier."""
        self.quantize_calls += 1
        return ops.kv_block_quantize(self.gather_blocks(rid, block_indices))

    def offload_blocks(self, rid: int, block_indices: list[int]) -> None:
        """Copy listed LOGICAL blocks of rid to host in ONE gather and ONE
        device-to-host copy (synchronous path of the D2H lane)."""
        if not block_indices:
            return
        data = _host(self.gather_blocks(rid, block_indices))
        self.tier.put(rid, {bi: data[i]
                            for i, bi in enumerate(block_indices)})

    def host_store(self, rid: int, blocks: dict) -> None:
        """Land completed async D2H transfers in the host tiers: fp32
        arrays go hot, quantized ``(vals, scales)`` tuples (the int8 D2H
        wire) go straight cold."""
        quant = {bi: v for bi, v in blocks.items() if isinstance(v, tuple)}
        raw = {bi: v for bi, v in blocks.items()
               if not isinstance(v, tuple)}
        if raw:
            self.tier.put(rid, raw)
        if quant:
            self.tier.put_cold(rid, quant)

    def drop_device_blocks(self, rid: int) -> None:
        """Drop rid's device references (eviction); shared physical blocks
        survive under their remaining referents, host copies survive."""
        for b in self.tables.get(rid, []):
            self.decref(b)
        self.tables[rid] = []

    def _upload(self, entries: list) -> torch.Tensor:
        """One tier group's wire payloads as an (n, L, 2, bs, Hkv, hd)
        device tensor: fp32 arrays are stacked and uploaded; int8 ``(vals,
        scales)`` pairs travel as int8 and are dequantized ON DEVICE in one
        call.  A group lives in one tier, so its payloads never mix."""
        quant = isinstance(entries[0], tuple)
        assert all(isinstance(e, tuple) == quant for e in entries), \
            "a tier group mixes int8 and fp32 payloads"
        tier = self.tier
        if not quant:
            return tier._to_device(entries)
        self.dequantize_calls += 1
        tier.cold_reload_blocks += len(entries)
        return ops.kv_block_dequantize(tier._to_device([e[0] for e in entries]),
                                       tier._to_device([e[1] for e in entries]))

    def reload_blocks(self, rid: int, n_blocks: int) -> int:
        """Restore the first n host blocks of rid to fresh device blocks in
        ONE batched host-to-device scatter (a cold int8 group is
        dequantized on the device in one call).  Returns tokens restored."""
        n = 0
        while n < n_blocks and self.tier.has_block(rid, n):
            n += 1
        n = min(n, len(self.free))
        if n == 0:
            return 0
        self.alloc(rid, n)
        self._scatter(self.tables[rid][-n:],
                      self._upload(self.tier.payloads(rid, range(n))))
        return n * self.block_size

    def reload_from_device(self, rid: int, staged, n_blocks: int) -> int:
        """Staged variant of ``reload_blocks``: ``staged`` is a
        (m, L, 2, bs, Hkv, hd) tensor the background H2D lane already
        landed on device; scatter its first ``n_blocks`` into freshly
        allocated blocks in one pass.  Returns tokens restored."""
        n = min(n_blocks, staged.shape[0])
        dst: list[int] = []
        for _ in range(n):
            if not self.alloc(rid, 1):
                break
            dst.append(self.tables[rid][-1])
        if not dst:
            return 0
        self._scatter(dst, staged[:len(dst)])
        return len(dst) * self.block_size

    def host_blocks(self, rid: int) -> int:
        return self.tier.n_blocks(rid)

    # --- radix-cache spill groups (physical blocks, no table) -------------
    def spill_cache_blocks(self, host_rid: int, phys: list[int]) -> None:
        """Spill cache-owned physical blocks to the tier under a pseudo-rid
        (keyed 0..n-1 in spill order).  One device gather; when the put
        would land demote-bound anyway, the gather is QUANTIZED on device
        so the D2H wire is int8."""
        g = self._gather(phys)
        if self.tier.prefer_cold(len(phys)):
            vals, scales = ops.kv_block_quantize(g)
            self.quantize_calls += 1
            vals, scales = _host(vals), _host(scales)
            self.tier.put_cold(host_rid, {i: (vals[i], scales[i])
                                          for i in range(len(phys))})
        else:
            data = _host(g)
            self.tier.put(host_rid, {i: data[i] for i in range(len(phys))})

    def _alloc_free_blocks(self, n: int) -> list[int]:
        if len(self.free) < n:
            return []
        phys = []
        for _ in range(n):
            b = self.free.pop()
            self.refcount[b] = 1
            phys.append(b)
        return phys

    def restore_cache_group(self, host_rid: int, n: int) -> list[int]:
        """Reload a spilled cache group to fresh device blocks in ONE
        batched scatter; cold (int8) payloads travel the narrow wire and
        are dequantized ON DEVICE.  Returns the new physical block ids
        ([] if blocks are missing or the device pool is full)."""
        entries = self.tier.payloads(host_rid, list(range(n)))
        if entries is None:
            return []
        phys = self._alloc_free_blocks(n)
        if not phys:
            return []
        data = self._upload(entries)
        self._scatter(phys, data)
        self.tier.drop(host_rid)
        return phys

    def adopt_staged_group(self, host_rid: int, staged, n: int) -> list[int]:
        """Like ``restore_cache_group`` but the H2D copy already landed:
        ``staged`` is the (m, L, 2, bs, Hkv, hd) device buffer the transfer
        worker pre-staged for this group."""
        if staged.shape[0] < n:
            return []
        phys = self._alloc_free_blocks(n)
        if not phys:
            return []
        self._scatter(phys, staged[:n])
        self.tier.drop(host_rid)
        return phys
