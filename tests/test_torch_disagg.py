"""The port's disaggregated fleet (``Engine(role="prefill"|"decode",
device="cpu")`` under ``ServiceController`` and GoRouting with
``pd_mode="disagg"``) on the reference's ``tests/test_disagg.py``
fixtures, against greedy decoding by the JAX package's ``forward`` on the
same parameters: the {prefix cache} x {overlap} x {int8 wire} matrix,
int8 determinism, the handoff accounting and its leak checks, and the
reservations over two decode replicas.  The five churn kills are in
``tests/test_torch_service.py``.

int8 wire note: the handoff quantizes each (layer, K/V) plane to int8
(``|x - deq| <= scale/2``), a lossy but deterministic wire; the
reference scanned its seeds for streams that survive the roundtrip, and
these are its seeds and lengths."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import (SLO, EngineConfig, GoRouting, Request,
                              RouterConfig, make_policy)
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Engine, HandoffPayload, ServiceController

from _torch_port_util import greedy_oracle

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
TREE = jax.tree.map(np.asarray, jax_init_params(CFG, jax.random.PRNGKey(0)))
TPARAMS = params_from_numpy(TREE, device="cpu")
SLO_LOOSE = SLO(3600.0, 3600.0)
PLEN, OLEN = 24, 8
SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def oracle():
    return greedy_oracle(CFG, TREE)


def make_engine(role="coloc", *, prefix_cache=True, overlap=True,
                handoff_quantize=False, num_blocks=128):
    return Engine(TCFG, TPARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  make_policy("slidebatching"), num_blocks=num_blocks,
                  block_size=16, max_ctx=256, role=role,
                  prefix_cache=prefix_cache, overlap_transfers=overlap,
                  packed_prefill=overlap,
                  handoff_quantize=handoff_quantize, device="cpu")


def make_controller():
    est = BatchLatencyEstimator(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8,
                                b_d=1e-3, t_c=1e-2)
    return ServiceController(GoRouting(est, RouterConfig(pd_mode="disagg")),
                             est)


def fixture_prompts():
    return [np.random.default_rng(s).integers(1, CFG.vocab, PLEN)
            .astype(np.int32) for s in SEEDS]


def run_disagg(*, prefix_cache, overlap, int8, prompts, n_decode=1):
    """One disagg fleet pass; returns (streams in submission order,
    controller, prefill engine, decode engines)."""
    svc = make_controller()
    pe = make_engine("prefill", prefix_cache=prefix_cache, overlap=overlap,
                     handoff_quantize=int8)
    des = [make_engine("decode", prefix_cache=prefix_cache,
                       overlap=overlap) for _ in range(n_decode)]
    svc.add_instance(pe)
    for de in des:
        svc.add_instance(de)
    reqs = []
    for p in prompts:
        r = Request(prompt_len=len(p), output_len=OLEN, arrival=0.0,
                    slo=SLO_LOOSE, priority=1)
        svc.submit(r, p)
        reqs.append(r)
    svc.serve_until_drained()
    streams = []
    for r in reqs:
        for de in des:
            if r.rid in de.outputs:
                streams.append(de.outputs[r.rid])
                break
        else:
            streams.append(None)
    for eng in (pe, *des):
        eng.kill()
    return streams, svc, pe, des


def refs(oracle):
    return [oracle(p, OLEN) for p in fixture_prompts()]


MATRIX = list(itertools.product((True, False), (True, False),
                                (True, False)))


@pytest.mark.parametrize("prefix_cache,overlap,int8", MATRIX,
                         ids=lambda v: str(v))
def test_disagg_streams_equal_greedy_forward(prefix_cache, overlap, int8,
                                             oracle):
    """Every cell of the matrix reproduces greedy decoding by the JAX
    forward token for token, every request travels the two-leg path, and
    the int8 wire is narrower than fp32."""
    streams, svc, pe, (de,) = run_disagg(
        prefix_cache=prefix_cache, overlap=overlap, int8=int8,
        prompts=fixture_prompts())
    assert len(svc.finished) == len(SEEDS)
    for got, want, seed in zip(streams, refs(oracle), SEEDS):
        assert got == want, (
            f"disagg stream diverged (cache={prefix_cache}, "
            f"overlap={overlap}, int8={int8}, seed={seed})")
    assert pe.stats.handoffs_out == len(SEEDS)
    assert de.stats.handoffs_in == len(SEEDS)
    if int8:
        assert (pe.stats.handoff_bytes_out
                < pe.stats.handoff_blocks_out * pe.pool.tier.block_bytes)
        # one quantize per export on the prefill side, one dequantize per
        # adoption on the decode side
        assert pe.pool.quantize_calls == pe.stats.handoffs_out
        assert de.pool.dequantize_calls == de.stats.handoffs_in
    else:
        assert (pe.stats.handoff_bytes_out
                == pe.stats.handoff_blocks_out * pe.pool.tier.block_bytes)
        assert pe.pool.quantize_calls == 0
        assert de.pool.dequantize_calls == 0
    # every export is one gather of its own
    assert pe.pool.gather_calls >= pe.stats.handoffs_out


def test_disagg_int8_wire_deterministic():
    """Quantization is lossy but deterministic: two identical disagg-int8
    replays produce identical streams and identical wire accounting."""
    runs = []
    for _ in range(2):
        streams, svc, pe, _ = run_disagg(prefix_cache=False, overlap=True,
                                         int8=True,
                                         prompts=fixture_prompts())
        runs.append((streams, pe.stats.handoff_bytes_out,
                     svc.book.handoff_blocks))
    assert runs[0] == runs[1]


def test_disagg_handoff_accounting_invariants(oracle):
    """Reserved decode blocks == adopted blocks, every reservation settles
    as a hit, engine-level counters mirror the book, and nothing leaks:
    no host-tier group for a real rid, no pending/ready export state, no
    standing reservation, zero reserved blocks on every instance."""
    streams, svc, pe, (de,) = run_disagg(prefix_cache=False, overlap=True,
                                         int8=False,
                                         prompts=fixture_prompts())
    assert streams == refs(oracle)
    book = svc.book
    n = len(SEEDS)
    assert book.handoffs == n
    assert book.reservation_hits == n
    assert book.reservation_misses == 0
    assert book.reserved_blocks_total == book.adopted_blocks_total > 0
    assert book.reservations == {}
    assert (pe.stats.handoffs_out, pe.stats.handoff_blocks_out,
            pe.stats.handoff_bytes_out) == \
        (book.handoffs, book.handoff_blocks, book.handoff_bytes)
    assert (de.stats.handoffs_in, de.stats.handoff_blocks_in,
            de.stats.handoff_bytes_in) == \
        (book.handoffs, book.handoff_blocks, book.handoff_bytes)
    assert pe.stats.transfer_failures == de.stats.transfer_failures == 0
    for st in book.states.values():
        assert st.reserved_blocks == 0
    for eng in (pe, de):
        assert eng._handoff_wait == {} and eng._handoff_ready == []
        assert eng.queue == []
        assert eng.bm.used_blocks == 0
        for tier_dict in (eng.pool.tier.hot, eng.pool.tier.cold):
            assert not [rid for rid in tier_dict if rid >= 0]


def test_disagg_reservations_spread_decode_replicas(oracle):
    """With two decode replicas, admission-time reservations steer the
    router: all requests still finish exactly, reservations all settle,
    and adopted == reserved even across multiple targets."""
    streams, svc, pe, des = run_disagg(prefix_cache=False, overlap=True,
                                       int8=False,
                                       prompts=fixture_prompts(),
                                       n_decode=2)
    assert streams == refs(oracle)
    book = svc.book
    assert book.reservation_hits == len(SEEDS)
    assert book.reserved_blocks_total == book.adopted_blocks_total
    assert sum(d.stats.handoffs_in for d in des) == len(SEEDS)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_payload_round_trip_restores_the_blocks(int8):
    """An export lands in the adopting pool's blocks as a colocated
    replica holds them after the same prefill: fp32 bitwise, int8 within
    scale / 2 per (layer, K/V) plane (plus fp32 rounding), through one
    on-device dequantize."""
    prompt = fixture_prompts()[0]

    def request():
        return Request(prompt_len=PLEN, output_len=OLEN, arrival=0.0,
                       slo=SLO_LOOSE, priority=1)

    coloc = make_engine(prefix_cache=False, overlap=False)
    rc = request()
    coloc.add_request(rc, prompt)
    coloc.step()
    want = coloc.pool.kv[:, :, coloc.pool.tables[rc.rid]].movedim(2, 0)
    src = make_engine("prefill", prefix_cache=False, overlap=False,
                      handoff_quantize=int8)
    dst = make_engine("decode", prefix_cache=False, overlap=False)
    r = request()
    src.add_request(r, prompt)
    src.step()
    payload, = src.take_handoffs()
    assert isinstance(payload, HandoffPayload)
    assert payload.kv_tokens == PLEN and payload.n_blocks == 2
    assert payload.outputs == coloc.outputs[rc.rid]
    assert src.pool.tables == {} and src.bm.used_blocks == 0
    assert dst.import_handoff(payload)
    got = dst.pool.kv[:, :, dst.pool.tables[r.rid]].movedim(2, 0)
    if int8:
        scales = torch.from_numpy(np.stack([s for _, s in
                                            payload.payloads]))
        err = (got - want).abs().flatten(3).amax(-1)
        assert bool((err <= scales * (0.5 + 3 * 127 * 2.0 ** -24)).all())
        assert dst.pool.dequantize_calls == 1
        assert src.pool.quantize_calls == 1
    else:
        assert torch.equal(got, want)
        assert dst.pool.dequantize_calls == 0
    assert dst.outputs[r.rid] == payload.outputs
    for eng in (coloc, src, dst):
        eng.kill()
