"""The port's PagedKVPool and RadixPrefixCache against the JAX package's:
the same operations give the same block tables, refcounts, free lists and
cache decisions; copy-on-write and offload -> drop -> reload move the
right bytes in place on the port's pool tensor."""
import numpy as np
import torch

from repro.configs import get_smoke
from repro.core import BlockManager as JBlockManager
from repro.serving import PagedKVPool as JPool
from repro.serving import RadixPrefixCache as JCache
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import BlockManager as TBlockManager
from repro_torch.serving import PagedKVPool as TPool
from repro_torch.serving import RadixPrefixCache as TCache


def pools(num_blocks=64):
    return (JPool(get_smoke("qwen1_5_0_5b"), num_blocks, 16),
            TPool(t_get_smoke("qwen1_5_0_5b"), num_blocks, 16,
                  device="cpu"))


def same_state(j, t):
    assert t.tables == j.tables
    assert t.refcount == j.refcount
    assert t.free == j.free


def test_random_alloc_share_fork_release_mirror_jax():
    j, t = pools()
    rng = np.random.default_rng(0)
    live = []
    for step in range(300):
        op = rng.random()
        if op < 0.4 or not live:
            rid, n = 1000 + step, int(rng.integers(1, 4))
            assert j.alloc(rid, n) == t.alloc(rid, n)
            if rid in t.tables:
                live.append(rid)
        elif op < 0.6:
            src = int(rng.choice(live))
            rid = 2000 + step
            k = int(rng.integers(1, len(t.tables[src]) + 1))
            j.share(rid, j.tables[src][:k])
            t.share(rid, t.tables[src][:k])
            live.append(rid)
        elif op < 0.8:
            rid = int(rng.choice(live))
            tb = t.tables.get(rid, [])
            if tb and t.free:
                li = int(rng.integers(0, len(tb)))
                assert j.ensure_writable(rid, li) == \
                    t.ensure_writable(rid, li)
        else:
            rid = live.pop(int(rng.integers(0, len(live))))
            j.release(rid)
            t.release(rid)
        same_state(j, t)
    for rid in live:
        t.release(rid)
    assert len(t.free) == 63                       # block 0 reserved


def test_fork_copies_the_block_in_place():
    _, pool = pools(32)
    kv = pool.kv
    assert pool.alloc(1, 2)
    pool.kv[:, :, pool.tables[1][0]] = 1.25
    pool.share(2, pool.tables[1])
    shared_b = pool.tables[2][0]
    assert pool.ensure_writable(2, 0)
    new_b = pool.tables[2][0]
    assert new_b != shared_b and pool.refcount[shared_b] == 1
    assert pool.kv is kv                            # updated in place
    assert torch.equal(pool.kv[:, :, new_b], pool.kv[:, :, shared_b])


def test_offload_drop_reload_round_trip():
    _, pool = pools(32)
    assert pool.alloc(1, 3)
    g = torch.Generator().manual_seed(0)
    for b in pool.tables[1]:
        pool.kv[:, :, b] = torch.randn(pool.kv[:, :, b].shape, generator=g)
    before = [pool.kv[:, :, b].clone() for b in pool.tables[1]]
    pool.offload_blocks(1, [0, 1, 2])
    assert pool.host_blocks(1) == 3
    assert pool.tier.host_bytes == 3 * pool.tier.block_bytes
    pool.drop_device_blocks(1)
    pool.alloc(9, 1)
    pool.release(9)                      # must not disturb rid 1's host set
    assert pool.host_blocks(1) == 3
    assert pool.reload_blocks(1, 3) == 3 * pool.block_size
    for want, b in zip(before, pool.tables[1]):
        assert torch.equal(pool.kv[:, :, b], want)
    snap = pool.gather_blocks(1, [2, 0])
    assert snap.shape == (2,) + tuple(pool.kv[:, :, 0].shape)
    assert torch.equal(snap[0], before[2]) and torch.equal(snap[1], before[0])


def test_table_array_pads_with_the_null_block():
    _, pool = pools(32)
    pool.alloc(1, 3)
    pool.alloc(2, 1)
    arr = pool.table_array([1, 2], maxp=4, rows=4)
    assert arr.dtype == torch.int32 and arr.shape == (4, 4)
    assert arr[0, :3].tolist() == pool.tables[1]
    assert arr[1, 1:].tolist() == [0, 0, 0] and arr[2:].sum() == 0


def caches(num_blocks=64):
    j, t = pools(num_blocks)
    jbm, tbm = JBlockManager(63, 16, 1e-3), TBlockManager(63, 16, 1e-3)
    return (j, jbm, JCache(j, jbm, max_blocks=32)), \
        (t, tbm, TCache(t, tbm, max_blocks=32))


def test_radix_cache_mirrors_jax():
    """Inserts with shared prefixes and splits, capped matches, pinned
    and shared blocks surviving reclaim, priority-weighted LRU eviction:
    every return value, the hit rate and the pool state equal the JAX
    cache's."""
    rng = np.random.default_rng(7)
    a = rng.integers(1, 999, 80).astype(np.int32)
    b = np.concatenate([a[:32], rng.integers(1, 999, 40)]).astype(np.int32)
    c = rng.integers(1, 999, 48).astype(np.int32)
    results = []
    for pool, bm, cache in caches():
        out = []
        for rid, toks, now, w in ((1, a, 0.0, 1.0), (2, b, 1.0, 2.0),
                                  (3, c, 2.0, 1.0)):
            assert pool.ensure_capacity(rid, len(toks))
            n = cache.insert(toks, pool.tables[rid], rid, now=now, weight=w)
            bm.charge_cache(n)
            out.append(n)
        out.append(cache.cached_blocks)
        out.append(cache.hit_rate())               # no match yet: 0.0
        out.append(cache.match(a, now=3.0, rid=4))
        out.append(cache.match(b, now=3.0, rid=5))
        out.append(cache.match(a[:16], now=3.0, rid=6))
        out.append(cache.reclaim(100))             # pinned: nothing
        for rid in (1, 2, 3, 4, 5):
            cache.detach(rid)
        out.append(cache.reclaim(100))             # shared with tables
        for rid in (1, 2, 3):
            pool.release(rid)
        out.append(cache.reclaim(3))               # LRU, weight-aware
        out.append(cache.match(b, now=4.0, rid=7))
        out.append(cache.reclaim(100))
        out.append((cache.cached_blocks, bm.cache_charge, pool.free[:],
                    cache.hit_rate()))
        results.append(out)
    assert results[1] == results[0]
    assert results[0][5][0] == 64 and results[0][8] == 0
