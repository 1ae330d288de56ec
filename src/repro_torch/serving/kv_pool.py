"""Paged KV pool: the device-side block store and its host mirror (port of
``repro.serving.kv_pool``).

Layout: one device tensor ``(L, 2, num_blocks, block_size, Hkv, hd)``
(k=0 / v=1), addressed through per-request block tables.  Where the JAX
pool rebinds a new functional array after every ``.at[].set``, this pool
is updated IN PLACE (``index_put_`` / slice assignment on ``self.kv``);
the tensor object never changes.

Physical blocks are REFERENCE COUNTED so several block tables (and the
radix prefix cache, ``serving/prefix_cache.py``) can point at the same
device block: ``share`` appends existing blocks to another request's
table, ``fork`` implements copy-on-write for writes into a shared block,
and a block returns to the free list only when its last reference drops.

The host side is ``KVTierStore`` with an unbounded fp32 host tier only
(the reference's ``budget_bytes=None`` mode, bitwise-identical streams);
the bounded host tier and the int8 cold tier are not ported yet.

The pool is DATA only; residency accounting and eviction policy live in
``core.blocks.BlockManager``, shared with the simulator.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.model import ArchConfig, resolve_device


class KVTierStore:
    """Off-device block store: fp32 host copies keyed rid -> {logical
    block index -> (L, 2, bs, Hkv, hd) array}.  Unbounded, like the
    reference's ``budget_bytes=None`` host tier."""

    def __init__(self, block_bytes: int):
        self.block_bytes = block_bytes
        self.hot: dict[int, dict[int, np.ndarray]] = {}

    @property
    def hot_blocks(self) -> int:
        return sum(len(d) for d in self.hot.values())

    @property
    def host_bytes(self) -> int:
        return self.hot_blocks * self.block_bytes

    def n_blocks(self, rid: int) -> int:
        return len(self.hot.get(rid, ()))

    def has_block(self, rid: int, bi: int) -> bool:
        return bi in self.hot.get(rid, ())

    def put(self, rid: int, blocks: dict) -> None:
        if blocks:
            self.hot.setdefault(rid, {}).update(blocks)

    def get_block(self, rid: int, bi: int) -> Optional[np.ndarray]:
        return self.hot.get(rid, {}).get(bi)

    def drop(self, rid: int) -> None:
        self.hot.pop(rid, None)


class PagedKVPool:
    def __init__(self, cfg: ArchConfig, num_blocks: int, block_size: int,
                 dtype=torch.float32, device="cuda",
                 host_tier_bytes: Optional[int] = None):
        if host_tier_bytes is not None:
            raise NotImplementedError(
                "the bounded host tier (host_tier_bytes) is not ported yet")
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
        block_bytes = (cfg.n_layers * 2 * block_size * cfg.n_kv_heads
                       * cfg.hd * self.kv.element_size())
        self.tier = KVTierStore(block_bytes)

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

    def table_array(self, rids: list[int], maxp: Optional[int] = None,
                    rows: Optional[int] = None) -> torch.Tensor:
        """Padded block-table batch as an int32 device tensor.  ``rows`` >
        len(rids) appends all-zero rows (the fused decode path pads the
        batch to a shape bucket; zero rows address the null block 0)."""
        maxp = maxp or max(len(self.tables[r]) for r in rids)
        out = np.zeros((rows or len(rids), maxp), np.int32)
        for i, r in enumerate(rids):
            t = self.tables[r]
            out[i, :len(t)] = t
        return torch.from_numpy(out).to(self.device)

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
    def _phys(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.device)

    def gather_blocks(self, rid: int, block_indices: list[int]):
        """Device-side copy of rid's logical blocks, shaped
        (n, L, 2, bs, Hkv, hd).  Advanced indexing allocates a new tensor,
        so later in-place pool writes cannot disturb it."""
        t = self.tables[rid]
        phys = self._phys([t[bi] for bi in block_indices])
        return self.kv[:, :, phys].movedim(2, 0)

    def offload_blocks(self, rid: int, block_indices: list[int]) -> None:
        """Copy listed LOGICAL blocks of rid to host in ONE gather and ONE
        device-to-host copy (the synchronous offload path)."""
        if not block_indices:
            return
        data = self.gather_blocks(rid, block_indices).cpu().numpy()
        self.tier.put(rid, {bi: data[i]
                            for i, bi in enumerate(block_indices)})

    def drop_device_blocks(self, rid: int) -> None:
        """Drop rid's device references (eviction); shared physical blocks
        survive under their remaining referents, host copies survive."""
        for b in self.tables.get(rid, []):
            self.decref(b)
        self.tables[rid] = []

    def reload_blocks(self, rid: int, n_blocks: int) -> int:
        """Restore the first n host blocks of rid to fresh device blocks in
        ONE batched host-to-device scatter.  Returns tokens restored."""
        restorable = []
        for bi in range(n_blocks):
            blk = self.tier.get_block(rid, bi)
            if blk is None or not self.alloc(rid, 1):
                break
            restorable.append((self.tables[rid][-1], blk))
        if not restorable:
            return 0
        dst = self._phys([b for b, _ in restorable])
        # host blocks are (L, 2, bs, Hkv, hd); stack -> (n, L, 2, ...) and
        # move the block axis behind (L, 2) to match self.kv's layout
        data = torch.from_numpy(np.stack([blk for _, blk in restorable]))
        self.kv[:, :, dst] = data.to(self.device).movedim(0, 2)
        return len(restorable) * self.block_size

    def host_blocks(self, rid: int) -> int:
        return self.tier.n_blocks(rid)
