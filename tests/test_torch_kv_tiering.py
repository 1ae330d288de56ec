"""The port's tiered KV store against the JAX package's: the plain
``kv_block_quantize`` / ``kv_block_dequantize`` / ``block_gather`` bitwise
equal to the Pallas kernels in interpret mode and to ``repro.kernels.ref``;
``KVTierStore`` op for op against the JAX store; the radix cache's spill,
restore and re-adoption; and the port's tiered engine (lanes on, exact
fp32 cold tier) emitting the JAX greedy stream, as
``tests/test_kv_tiering.py`` does for the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import BlockManager as JBlockManager
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import PagedKVPool as JPool
from repro.serving import RadixPrefixCache as JCache
from repro.serving.kv_pool import KVTierStore as JTierStore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import SLO, BlockManager, EngineConfig, Request
from repro_torch.core import SlideBatching
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (Engine, KVTierStore, PagedKVPool,
                                 RadixPrefixCache, TransferWorker)

from _torch_port_util import greedy_oracle, perturbed_numpy_params

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
BSHAPE = (2, 2, 4, 1, 4)            # synthetic block (L, 2, bs, Hkv, hd)


def blk(rng):
    return rng.standard_normal(BSHAPE).astype(np.float32)


# --------------------------------------------------------------------------
# plain kernels against the JAX kernels (interpret mode) and oracles
# --------------------------------------------------------------------------

def quant_input(shape, seed):
    """Normal values with a zero plane and a plane of exact half steps
    (k + 0.5 after scaling), where round-half-even matters."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 1] = 0.0
    e = int(np.prod(shape[3:]))
    # absmax 127 -> scale 1: every value sits on a half step
    half = (np.arange(e, dtype=np.float32) % 254) - 126.5
    half[0] = 127.0
    x[-1, -1, 0] = half.reshape(shape[3:])
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 2, 2, 4, 2, 8), (2, 4, 2, 16, 2, 16),
                                   (1, 1, 2, 3, 1, 5)])
def test_quantize_plain_bitwise_equals_jax(shape, dtype):
    x = torch.as_tensor(quant_input(shape, sum(shape)))
    if dtype == "bfloat16":
        x = x.bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    vals, scales = tops.kv_block_quantize(x)
    assert vals.dtype == torch.int8 and scales.dtype == torch.float32
    for jv, js in (jops.kv_block_quantize(xj, interpret=True),
                   jref.kv_block_quantize_ref(xj)):
        assert np.array_equal(vals.numpy(), np.asarray(jv))
        assert np.array_equal(scales.numpy(), np.asarray(js))
    assert not vals[0, 0, 1].any() and scales[0, 0, 1] == 0
    deq = tops.kv_block_dequantize(vals, scales)
    for want in (jops.kv_block_dequantize(jnp.asarray(vals.numpy()),
                                          jnp.asarray(scales.numpy()),
                                          interpret=True),
                 jref.kv_block_dequantize_ref(jnp.asarray(vals.numpy()),
                                              jnp.asarray(scales.numpy()))):
        assert np.array_equal(deq.numpy(), np.asarray(want))
    # the documented bound: |x - x'| <= scale / 2 per element
    err = (deq - x.float()).abs().reshape(*scales.shape, -1).amax(-1)
    assert bool((err <= scales * 0.5 + 1e-6).all())


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n_pages,idx", [(9, [3, 0, 8, 3]), (4, [1]),
                                         (16, list(range(15, -1, -1)))])
def test_block_gather_plain_bitwise_equals_jax(n_pages, idx, dtype):
    rng = np.random.default_rng(n_pages)
    pool = (rng.standard_normal((n_pages, 4, 2, 8)) * 100).astype(dtype)
    got = tops.block_gather(torch.as_tensor(pool), torch.tensor(idx))
    ji = jnp.asarray(idx, jnp.int32)
    for want in (jops.block_gather(jnp.asarray(pool), ji, interpret=True),
                 jref.block_gather_ref(jnp.asarray(pool), ji)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_block_gather_pool_form_is_the_snapshot_layout():
    rng = np.random.default_rng(3)
    kv = torch.as_tensor(rng.standard_normal((3, 2, 10, 4, 2, 8)),
                         dtype=torch.float32)
    idx = [7, 2, 9]
    got = tops.block_gather(kv, torch.tensor(idx, dtype=torch.int32), 2)
    assert got.shape == (3, 3, 2, 4, 2, 8)
    assert torch.equal(got, kv[:, :, idx].movedim(2, 0))
    # the JAX form is the one-plane case of the same function
    assert torch.equal(tref.block_gather_ref(kv[0, 1], idx), got[:, 0, 1])


# --------------------------------------------------------------------------
# KVTierStore op for op against the JAX store
# --------------------------------------------------------------------------

def _wire(x: np.ndarray):
    v, s = tref.kv_block_quantize_ref(torch.as_tensor(x[None]))
    return v[0].numpy(), s[0].numpy()


def _same_payload(a, b) -> bool:
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and np.array_equal(a[0], np.asarray(b[0]))
                and np.array_equal(a[1], np.asarray(b[1])))
    return not isinstance(b, tuple) and np.array_equal(a, np.asarray(b))


def _same_store(t: KVTierStore, j: JTierStore) -> None:
    for mine, theirs in ((t.hot, j.hot), (t.cold, j.cold)):
        assert ({r: sorted(g) for r, g in mine.items() if g}
                == {r: sorted(g) for r, g in theirs.items() if g})
        for r, g in mine.items():
            for bi, v in g.items():
                assert _same_payload(v, theirs[r][bi])
    assert t._touch == j._touch
    assert (t.demoted_blocks, t.cold_reload_blocks, t.host_bytes,
            t.cold_blocks) == (j.demoted_blocks, j.cold_reload_blocks,
                               j.host_bytes, j.cold_blocks)


@pytest.mark.parametrize("cold_quantize", [True, False])
def test_tier_store_mirrors_jax_op_for_op(cold_quantize):
    """Random puts, reads, int8-wire puts, splits, payload fetches and
    drops under a 4-block budget: both stores hold the same hot and cold
    groups, pick the same LRU victims and keep bitwise-equal payloads."""
    t = KVTierStore(1, 4, cold_quantize, device="cpu")
    j = JTierStore(1, 4, cold_quantize)
    rng = np.random.default_rng(5 + cold_quantize)
    next_rid = -1
    for step in range(160):
        op = rng.random()
        rid = int(rng.integers(1, 7))
        if op < 0.35:
            blocks = {int(b): blk(rng) for b in
                      rng.choice(6, int(rng.integers(1, 4)), replace=False)}
            t.put(rid, dict(blocks))
            j.put(rid, dict(blocks))
        elif op < 0.5:
            blocks = {int(b): _wire(blk(rng)) for b in
                      rng.choice(6, int(rng.integers(1, 3)), replace=False)}
            t.put_cold(rid, dict(blocks))
            j.put_cold(rid, dict(blocks))
        elif op < 0.7:
            bi = int(rng.integers(0, 6))
            got, want = t.get_block(rid, bi), j.get_block(rid, bi)
            assert (got is None) == (want is None)
            if got is not None:
                assert np.array_equal(got, np.asarray(want))
        elif op < 0.8:
            ids = list(range(int(rng.integers(1, 4))))
            got, want = t.payloads(rid, ids), j.payloads(rid, ids)
            assert (got is None) == (want is None)
            if got is not None:
                assert all(map(_same_payload, got, want))
        elif op < 0.9:
            at = int(rng.integers(1, 4))
            t.split_group(rid, at, next_rid)
            j.split_group(rid, at, next_rid)
            next_rid -= 1
        else:
            t.drop(rid)
            j.drop(rid)
        assert t.prefer_cold(2) == j.prefer_cold(2)
        _same_store(t, j)
    assert t.demoted_blocks > 0


def test_tier_unbounded_never_demotes():
    rng = np.random.default_rng(0)
    tier = KVTierStore(block_bytes=1, budget_bytes=None, device="cpu")
    for rid in range(8):
        tier.put(rid, {0: blk(rng), 1: blk(rng)})
    assert tier.cold_blocks == 0 and tier.demoted_blocks == 0
    assert tier.hot_blocks == 16 and tier.quantize_calls == 0


def test_tier_budget_demotes_lru_whole_groups():
    rng = np.random.default_rng(1)
    tier = KVTierStore(block_bytes=1, budget_bytes=2, cold_quantize=False,
                        device="cpu")
    tier.put(1, {0: blk(rng), 1: blk(rng)})
    tier.put(2, {0: blk(rng), 1: blk(rng)})  # over budget: rid 1 demotes
    assert tier.is_cold(1) and not tier.is_cold(2)
    assert tier.hot_blocks == 2 and tier.cold_blocks == 2
    assert not tier.hot.get(1) and not tier.cold.get(2)
    tier.get_block(1, 0)                      # rid 2 is now the LRU group
    tier.put(3, {0: blk(rng)})
    assert tier.is_cold(2)


def test_tier_quantized_roundtrip_bound_and_counters():
    rng = np.random.default_rng(2)
    tier = KVTierStore(block_bytes=1, budget_bytes=1, cold_quantize=True,
                        device="cpu")
    a = blk(rng)
    tier.put(1, {0: a})
    tier.put(2, {0: blk(rng)})               # demotes rid 1 over int8
    assert tier.is_cold(1) and tier.demoted_blocks == 1
    assert tier.quantize_calls == 1
    got = tier.get_block(1, 0)
    planes = a.reshape(BSHAPE[0] * BSHAPE[1], -1)
    scale = np.abs(planes).max(axis=1) * np.float32(1.0 / 127.0)
    err = np.abs(got - a).reshape(BSHAPE[0] * BSHAPE[1], -1).max(axis=1)
    assert np.all(err <= scale * 0.5 + 1e-7)
    assert tier.cold_reload_blocks == 1 and tier.dequantize_calls == 1
    tier.budget_bytes = 4                    # room for the whole group
    tier.put(1, {1: blk(rng)})               # promotion: one dequantize
    assert not tier.is_cold(1) and tier.n_blocks(1) == 2
    assert tier.dequantize_calls == 2


# --------------------------------------------------------------------------
# radix-cache spill / restore / re-adoption
# --------------------------------------------------------------------------

@pytest.fixture()
def spill_env():
    pool = PagedKVPool(TCFG, 32, 16, device="cpu", host_tier_bytes=1 << 30,
                       cold_quantize=False)
    bm = BlockManager(31, 16, 1e-3)
    cache = RadixPrefixCache(pool, bm, max_blocks=16, spill=True)
    return pool, bm, cache


def _prefill(pool, rid, tokens, fill=None):
    assert pool.ensure_capacity(rid, len(tokens))
    if fill is not None:
        for b in pool.tables[rid]:
            pool.kv[:, :, b] = fill
    return pool.tables[rid]


def _spilled_prompt(pool, bm, cache, rng, fill=None):
    toks = rng.integers(1, 999, 64).astype(np.int32)
    q = np.concatenate([toks, rng.integers(1, 999, 16)]).astype(np.int32)
    _prefill(pool, 1, toks, fill)
    adopted = cache.insert(toks, pool.tables[1], rid=1, now=0.0)
    assert adopted == 4
    bm.charge_cache(adopted)
    cache.detach(1)
    pool.release(1)
    return toks, q


def test_cache_spill_restore_roundtrip_exact(spill_env):
    pool, bm, cache = spill_env
    rng = np.random.default_rng(11)
    fill = torch.as_tensor(rng.standard_normal(
        pool.kv.shape[:2] + pool.kv.shape[3:]), dtype=torch.float32)
    _, q = _spilled_prompt(pool, bm, cache, rng, fill)
    free_before = len(pool.free)
    assert cache.reclaim(4) == 4                 # spills, does not destroy
    assert len(pool.free) == free_before + 4
    assert cache.stats.spilled_blocks == 4 and bm.cache_charge == 0
    assert pool.tier.hot_blocks == 4 and pool.gather_calls == 1
    n, blocks = cache.match(q, now=1.0, rid=2)   # restores on device
    assert n == 64 and len(blocks) == 4
    assert cache.stats.restored_blocks == 4 and bm.cache_charge == 4
    assert pool.tier.hot_blocks == 0
    for b in blocks:
        assert torch.equal(pool.kv[:, :, b], fill)


def test_cache_spill_readopt_on_insert(spill_env):
    pool, bm, cache = spill_env
    rng = np.random.default_rng(12)
    toks, q = _spilled_prompt(pool, bm, cache, rng)
    assert cache.reclaim(4) == 4
    _prefill(pool, 2, toks)                      # the prompt recomputed
    assert cache.insert(toks, pool.tables[2], rid=2, now=2.0) == 4
    assert cache.stats.readopted_blocks == 4
    assert cache.stats.restored_blocks == 0 and pool.tier.hot_blocks == 0
    assert cache.match(q, now=3.0, rid=3)[0] == 64


def test_cache_restore_pool_full_is_plain_miss(spill_env):
    pool, bm, cache = spill_env
    rng = np.random.default_rng(13)
    _, q = _spilled_prompt(pool, bm, cache, rng)
    assert cache.reclaim(4) == 4
    hog = pool._alloc_free_blocks(len(pool.free))
    assert cache.match(q, now=1.0, rid=2) == (0, [])
    assert pool.tier.hot_blocks == 4             # the copy survives
    for b in hog:
        pool.decref(b)
    assert cache.match(q, now=2.0, rid=3)[0] == 64


def test_cache_readopt_mid_reload_invalidates_staged_buffer(spill_env):
    pool, bm, cache = spill_env
    w = TransferWorker(max_staged=2, device="cpu")
    cache.worker = w
    try:
        rng = np.random.default_rng(14)
        toks, _ = _spilled_prompt(pool, bm, cache, rng)
        assert cache.reclaim(4) == 4
        (host_rid, payloads), = cache.spill_candidates(limit=1)
        assert w.prefetch(host_rid, 0, payloads)
        assert w.flush()
        _prefill(pool, 2, toks)
        assert cache.insert(toks, pool.tables[2], rid=2, now=2.0) == 4
        assert w.take_staged(host_rid, 0) is None
        assert not cache.has_spilled(host_rid)
    finally:
        w.stop()


def test_cache_spilled_match_uses_staged_buffer(spill_env):
    pool, bm, cache = spill_env
    w = TransferWorker(max_staged=2, device="cpu")
    cache.worker = w
    try:
        rng = np.random.default_rng(15)
        fill = torch.full(pool.kv.shape[:2] + pool.kv.shape[3:], 0.75)
        _, q = _spilled_prompt(pool, bm, cache, rng, fill)
        assert cache.reclaim(4) == 4
        (host_rid, payloads), = cache.spill_candidates(limit=1)
        assert w.prefetch(host_rid, 0, payloads)
        assert w.flush()
        n, blocks = cache.match(q, now=1.0, rid=2)
        assert n == 64 and cache.stats.staged_restores == 1
        assert all(torch.equal(pool.kv[:, :, b], fill) for b in blocks)
    finally:
        w.stop()


@pytest.mark.parametrize("cold_quantize", [False, True])
def test_spill_cache_mirrors_jax(cold_quantize):
    """Inserts, splits of spilled nodes, spills under a small host tier
    (int8 wire when demote-bound), restores and re-adoptions: the same
    return values, pool state, cache stats and tier membership as the
    JAX cache."""
    rng = np.random.default_rng(21)
    a = rng.integers(1, 999, 80).astype(np.int32)
    b = np.concatenate([a[:32], rng.integers(1, 999, 48)]).astype(np.int32)
    c = rng.integers(1, 999, 64).astype(np.int32)
    fill = rng.standard_normal((32,) + (CFG.n_layers, 2, 16, CFG.n_kv_heads,
                                        CFG.hd)).astype(np.float32)
    bb = CFG.n_layers * 2 * 16 * CFG.n_kv_heads * CFG.hd * 4
    runs = []
    for port in (False, True):
        if port:
            pool = PagedKVPool(TCFG, 32, 16, device="cpu",
                               host_tier_bytes=3 * bb,
                               cold_quantize=cold_quantize)
            pool.kv[:] = torch.as_tensor(np.moveaxis(fill, 0, 2))
            bm = BlockManager(31, 16, 1e-3)
            cache = RadixPrefixCache(pool, bm, max_blocks=12, spill=True)
        else:
            pool = JPool(CFG, 32, 16, host_tier_bytes=3 * bb,
                         cold_quantize=cold_quantize)
            pool.kv = jnp.asarray(np.moveaxis(fill, 0, 2))
            bm = JBlockManager(31, 16, 1e-3)
            cache = JCache(pool, bm, max_blocks=12, spill=True)
        out = []
        for rid, toks, now in ((1, a, 0.0), (2, c, 1.0)):
            assert pool.ensure_capacity(rid, len(toks))
            n = cache.insert(toks, pool.tables[rid], rid, now=now)
            bm.charge_cache(n)
            out.append(n)
            cache.detach(rid)
            pool.release(rid)
        out.append(cache.reclaim(9))             # spills both prompts
        out.append(cache.match(b, now=2.0, rid=3))   # splits a spilled node
        restored = cache.match(c, now=3.0, rid=4)    # restores c
        out.append(restored)
        assert pool.ensure_capacity(5, len(a))
        out.append(cache.insert(a, pool.tables[5], 5, now=4.0))  # re-adopts
        st = cache.stats
        out.append((st.spilled_blocks, st.restored_blocks,
                    st.readopted_blocks, st.evicted_blocks, st.hits))
        out.append((pool.tables, pool.refcount, pool.free, bm.cache_charge,
                    cache.cached_blocks))
        out.append(({r: sorted(g) for r, g in pool.tier.hot.items() if g},
                    {r: sorted(g) for r, g in pool.tier.cold.items() if g},
                    pool.tier.demoted_blocks, pool.tier.cold_reload_blocks))
        out.append([np.asarray(pool.kv[:, :, blk]).copy()
                    for blk in restored[1]])
        runs.append(out)
    jax_run, port_run = runs
    for got, want in zip(port_run[:-1], jax_run[:-1]):
        assert got == want
    for got, want in zip(port_run[-1], jax_run[-1]):
        assert np.array_equal(got, want)
    spilled, restored, readopted = port_run[6][:3]
    assert spilled > 0 and restored > 0 and readopted > 0
    tier_moves = port_run[8][2] + port_run[8][3]   # demoted + cold reloads
    assert tier_moves > 0


@pytest.mark.parametrize("cold_quantize", [False, True])
def test_pool_reload_of_demoted_group_mirrors_jax(cold_quantize):
    """A request's group demoted past a 2-block host tier, its device
    blocks dropped, then reloaded: the same restored tokens, tables, pool
    contents and tier counters as the JAX pool; the port dequantizes an
    int8 group on the device in one call."""
    rng = np.random.default_rng(22)
    fill = rng.standard_normal((16,) + (CFG.n_layers, 2, 16, CFG.n_kv_heads,
                                        CFG.hd)).astype(np.float32)
    bb = CFG.n_layers * 2 * 16 * CFG.n_kv_heads * CFG.hd * 4
    runs = []
    for port in (False, True):
        if port:
            pool = PagedKVPool(TCFG, 16, 16, device="cpu",
                               host_tier_bytes=2 * bb,
                               cold_quantize=cold_quantize)
            pool.kv[:] = torch.as_tensor(np.moveaxis(fill, 0, 2))
        else:
            pool = JPool(CFG, 16, 16, host_tier_bytes=2 * bb,
                         cold_quantize=cold_quantize)
            pool.kv = jnp.asarray(np.moveaxis(fill, 0, 2))
        assert pool.ensure_capacity(1, 48) and pool.ensure_capacity(2, 32)
        pool.offload_blocks(1, [0, 1, 2])        # over budget: demotes
        pool.offload_blocks(2, [0, 1])
        pool.drop_device_blocks(1)
        tokens = pool.reload_blocks(1, 3)
        t = pool.tier
        runs.append((tokens, {r: list(b) for r, b in pool.tables.items()},
                     t.demoted_blocks, t.cold_reload_blocks, t.hot_blocks,
                     t.cold_blocks, np.asarray(pool.kv).copy()))
        if port and cold_quantize:
            assert pool.dequantize_calls == 1 and t.dequantize_calls == 0
    (*want, want_kv), (*got, got_kv) = runs
    assert got == want and np.array_equal(got_kv, want_kv)
    assert got[0] == 48 and got[2] == 3


# --------------------------------------------------------------------------
# engine: cache on/off x tier on/off (exact fp32 cold tier), lanes on
# --------------------------------------------------------------------------

TREE = perturbed_numpy_params(CFG)
TPARAMS = params_from_numpy(TREE, device="cpu")
ORACLE = greedy_oracle(CFG, TREE)


def _matrix_prompts(seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, CFG.vocab, 32).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, CFG.vocab, 8 + 4 * i)
                            .astype(np.int32)]) for i in range(4)]


def _matrix_run(prompts, **kw):
    eng = Engine(TCFG, TPARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                 SlideBatching(), num_blocks=7, block_size=16, device="cpu",
                 **kw)
    reqs = []
    # staged admission: the first request seeds the radix cache
    for wave in (prompts[:1], prompts[1:]):
        for p in wave:
            r = Request(prompt_len=len(p), output_len=5, arrival=0.0,
                        slo=SLO(3600.0, 3600.0), priority=1)
            eng.add_request(r, p)
            reqs.append(r)
        eng.run_until_drained(max_iters=400)
    eng.flush_transfers()
    eng.kill()
    return eng, [eng.outputs[r.rid] for r in reqs]


def test_engine_tier_matrix_exact_mode_matches_jax_greedy():
    """Lanes on, exact fp32 cold tier: every cache x tier combination
    emits the JAX greedy stream; the tiny pool forces evictions, so the
    tiered runs spill, demote and reload on the live token path."""
    prompts = _matrix_prompts(31)
    refs = [ORACLE(p, 5) for p in prompts]
    bb = PagedKVPool(TCFG, 2, 16, device="cpu").tier.block_bytes
    demoted = 0
    for cache_on in (False, True):
        for tier_bytes in (None, 2 * bb):
            eng, outs = _matrix_run(prompts, prefix_cache=cache_on,
                                    host_tier_bytes=tier_bytes,
                                    cold_quantize=False)
            assert outs == refs, f"cache={cache_on} tier={tier_bytes}"
            assert eng.stats.transfer_failures == 0
            if tier_bytes is not None:
                assert eng.stats.evictions > 0
                assert eng.stats.host_bytes <= tier_bytes
                demoted += eng.pool.tier.demoted_blocks
    assert demoted > 0


def test_engine_int8_cold_tier_completes_under_pressure():
    prompts = _matrix_prompts(32)
    bb = PagedKVPool(TCFG, 2, 16, device="cpu").tier.block_bytes
    eng, outs = _matrix_run(prompts, prefix_cache=True,
                            host_tier_bytes=2 * bb, cold_quantize=True)
    assert all(len(o) == 5 for o in outs)
    assert eng.stats.spill_blocks > 0
    assert eng.stats.cold_blocks + eng.pool.tier.demoted_blocks > 0
    assert eng.stats.host_bytes <= 2 * bb
    quantized = eng.pool.quantize_calls + eng.pool.tier.quantize_calls
    assert quantized > 0
