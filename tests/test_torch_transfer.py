"""The port's background transfer lanes (``serving/transfer.py``) on the
CPU: the worker scenarios of ``tests/test_overlap_exec.py`` and
``tests/test_kv_tiering.py`` (stale epochs, slot release, failed-copy
reporting, the int8 wire), the pool's offload -> drop -> staged reload
round trip, and the engine with the lanes on: offloads land and feed the
copy budget, a pre-staged reload is consumed, and the streams equal the
JAX greedy stream and the same engine with the lanes off."""
import numpy as np
import torch

from repro.configs import get_smoke
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import SLO, BlockManager, EngineConfig, Request
from repro_torch.core import SlideBatching
from repro_torch.core.batching import BatchPlan
from repro_torch.kernels import ref as tref
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Engine, PagedKVPool, TransferWorker

from _torch_port_util import greedy_oracle, perturbed_numpy_params

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
TREE = perturbed_numpy_params(CFG, seed=3)
TPARAMS = params_from_numpy(TREE, device="cpu")
ORACLE = greedy_oracle(CFG, TREE)
BLK = (2, 2, 4, 2, 8)


def group(rng, n=2):
    return [rng.standard_normal(BLK).astype(np.float32) for _ in range(n)]


# --------------------------------------------------------------------------
# worker scenarios
# --------------------------------------------------------------------------

def test_stale_epoch_staging_discarded():
    w = TransferWorker(device="cpu")
    try:
        assert w.prefetch(5, 0, [np.zeros(BLK, np.float32)])
        assert w.flush()
        assert w.take_staged(5, 1) is None      # epoch bumped: stale
    finally:
        w.stop()


def test_stale_staging_slot_released_without_consumer():
    w = TransferWorker(max_staged=1, device="cpu")
    blk = np.zeros(BLK, np.float32)
    try:
        assert w.prefetch(5, 0, [blk])
        assert w.flush()
        w.discard_stale(5, current_epoch=1)     # what _drain_transfers does
        assert w.take_staged(5, 1) is None
        assert w.prefetch(6, 0, [blk])          # the slot is free again
        assert w.flush()
        w.discard_stale(6, current_epoch=0)     # current: kept
        n, arr = w.take_staged(6, 0)
        assert n == 1 and torch.equal(arr[0], torch.from_numpy(blk))
    finally:
        w.stop()


def test_invalidate_races_reload_and_frees_slot():
    rng = np.random.default_rng(0)
    w = TransferWorker(max_staged=1, device="cpu")
    try:
        assert w.prefetch(5, 0, group(rng))
        assert not w.prefetch(6, 0, group(rng))    # ring full
        assert w.flush()
        w.invalidate(5)                 # eviction races the staged buffer
        assert w.take_staged(5, 0) is None
        assert w.prefetch(6, 0, group(rng))
        assert w.flush()
        assert w.take_staged(6, 0) is not None
    finally:
        w.stop()


def test_failed_transfer_reported_and_pending_released():
    w = TransferWorker(device="cpu")
    try:
        assert w.prefetch(7, 0, [np.zeros(3), np.zeros(2)])  # stack raises
        assert w.flush()
        done = w.drain()
        assert len(done) == 1 and not done[0].ok and done[0].n_blocks == 2
        assert w.prefetch(8, 0, [np.zeros(3)])      # the slot was released
    finally:
        w.stop()
    bm = BlockManager(64, 16, 1e-3)
    bm.external_lanes = True
    bm.offload_sink = lambda *a: None
    r = Request(prompt_len=64, output_len=4, arrival=0.0,
                slo=SLO(10.0, 1.0), priority=3)
    assert bm.grow(r, 64, now=0.0)
    s = bm.state(r)
    assert s.pending_offload == 4
    bm.note_offload_failed(r.rid, 4)
    assert s.pending_offload == 0 and s.mirrored_blocks == 0


def test_quantized_wire_dequantizes_on_device():
    rng = np.random.default_rng(1)
    vals, scales = tref.kv_block_quantize_ref(
        torch.as_tensor(np.stack(group(rng, 3))))
    payloads = [(vals[i].numpy(), scales[i].numpy()) for i in range(3)]
    w = TransferWorker(max_staged=1, device="cpu")
    try:
        assert w.prefetch(7, 0, payloads)
        assert w.flush()
        done = w.drain()
        assert [(d.kind, d.quantized, d.ok) for d in done] == [
            ("h2d", True, True)]
        n, arr = w.take_staged(7, 0)
        assert n == 3 and w.dequantize_calls == 1
        assert torch.equal(arr, tref.kv_block_dequantize_ref(vals, scales))
    finally:
        w.stop()


def test_d2h_offload_lands_blocks_and_time():
    rng = np.random.default_rng(2)
    snap = torch.as_tensor(np.stack(group(rng, 3)))
    vals, scales = tref.kv_block_quantize_ref(snap)
    w = TransferWorker(device="cpu")
    try:
        w.offload(4, 2, [5, 6, 7], snap)
        w.offload(4, 2, [8, 9, 10], (vals, scales))
        assert w.flush()
        plain, quant = w.drain()
        assert (plain.kind, plain.rid, plain.epoch, plain.n_blocks) == (
            "d2h", 4, 2, 3)
        assert not plain.quantized and quant.quantized
        assert plain.seconds >= 0.0
        for i, bi in enumerate([5, 6, 7]):
            assert np.array_equal(plain.blocks[bi], snap[i].numpy())
        for i, bi in enumerate([8, 9, 10]):
            v, s = quant.blocks[bi]
            assert np.array_equal(v, vals[i].numpy())
            assert np.array_equal(s, scales[i].numpy())
    finally:
        w.stop()


def test_pool_offload_drop_staged_reload_round_trip():
    pool = PagedKVPool(TCFG, num_blocks=8, block_size=4, device="cpu")
    pool.alloc(1, 3)
    rng = np.random.default_rng(1)
    vals = torch.as_tensor(rng.standard_normal(
        (TCFG.n_layers, 2, 3, 4, TCFG.n_kv_heads, TCFG.hd)),
        dtype=torch.float32)
    pool.kv[:, :, pool.tables[1]] = vals
    pool.offload_blocks(1, [0, 1, 2])            # one gather, one copy
    assert sorted(pool.host[1]) == [0, 1, 2] and pool.gather_calls == 1
    pool.drop_device_blocks(1)
    w = TransferWorker(device="cpu")
    try:
        assert w.prefetch(1, 0, [pool.host[1][i] for i in range(3)])
        assert w.flush()
        staged = w.take_staged(1, 0)
        assert staged is not None and staged[0] == 3
        assert pool.reload_from_device(1, staged[1], 3) == 12
        assert torch.equal(pool.kv[:, :, pool.tables[1]], vals)
    finally:
        w.stop()


# --------------------------------------------------------------------------
# engine with the lanes on
# --------------------------------------------------------------------------

def make_engine(num_blocks=64, **kw):
    return Engine(TCFG, TPARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  SlideBatching(), num_blocks=num_blocks, block_size=16,
                  device="cpu", **kw)


def submit(eng, rng, plen, out_len, prio=2):
    r = Request(prompt_len=plen, output_len=out_len, arrival=0.0,
                slo=SLO(3600.0, 3600.0), priority=prio)
    prompt = rng.integers(1, CFG.vocab, plen).astype(np.int32)
    eng.add_request(r, prompt)
    return r, prompt


def test_async_offload_lands_and_feeds_accounting():
    rng = np.random.default_rng(4)
    eng = make_engine(num_blocks=24)
    reqs = [submit(eng, rng, 48, 3, prio=3) for _ in range(3)]
    eng.run_until_drained(max_iters=400)
    assert eng.flush_transfers()
    assert all(r.phase.name == "FINISHED" for r, _ in reqs)
    assert eng.stats.offload_blocks > 0, "no async D2H transfer completed"
    assert eng.stats.t_block_measured > 0, "measured t_block never fed back"
    assert eng.stats.t_block_measured == eng.bm.t_block
    assert eng.pool.gather_calls > 0 and eng.stats.transfer_failures == 0
    eng.kill()
    assert eng.step() is None


def test_staged_reload_hit_end_to_end():
    """Evict a request whose blocks were mirrored, let the worker pre-stage
    them, and the next reload consumes the staged buffer while the tokens
    stay those of JAX greedy decoding."""
    rng = np.random.default_rng(5)
    eng = make_engine()
    a, pa = submit(eng, rng, 64, 4, prio=3)   # 4 full blocks, n_off(3)=2
    while a.generated < 1:
        assert eng.step() is not None
        eng.flush_transfers()
    assert eng.bm.state(a).mirrored_blocks >= 4
    eng.bm.evict(a, eng.now)
    eng._sync_pool_with_bm(BatchPlan(evictions=[a]))
    assert eng.bm.state(a).host_tokens >= 64
    eng._prefetch_reloads()
    assert eng.flush_transfers()
    eng.run_until_drained(max_iters=100)
    assert eng.stats.staged_hits >= 1, "pre-staged reload never consumed"
    assert eng.stats.reload_blocks > 0
    assert eng.outputs[a.rid] == ORACLE(pa, 4)
    eng.kill()


def test_lanes_on_and_off_emit_the_same_streams():
    """Preemption traffic through the lanes and through synchronous
    copies: both emit the JAX greedy stream."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, CFG.vocab, 40).astype(np.int32)
               for _ in range(4)]
    outs = {}
    for overlap in (True, False):
        eng = make_engine(num_blocks=10, overlap_transfers=overlap)
        reqs = []
        for i, p in enumerate(prompts):
            r = Request(prompt_len=40, output_len=6, arrival=0.0,
                        slo=SLO(3600.0, 3600.0), priority=1 + i % 3)
            eng.add_request(r, p)
            reqs.append(r)
        eng.run_until_drained(max_iters=400)
        eng.flush_transfers()
        assert eng.stats.evictions > 0
        assert eng.stats.transfer_failures == 0
        outs[overlap] = [eng.outputs[r.rid] for r in reqs]
        eng.kill()
    assert outs[True] == outs[False]
    assert outs[True] == [ORACLE(p, 6) for p in prompts]
