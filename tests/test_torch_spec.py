"""Speculative decoding in the port against the JAX package, on the CPU:
the port's ``DraftRunner`` proposes what the JAX runner proposes on the
same weights; spec-on engine streams (a same-params draft, an other-seed
draft, preemption mid-stream) equal greedy decoding by the JAX package's
``forward``; and with the estimator shared and its online refit frozen
(as ``tools/perf_smoke.py``'s ``measure_spec`` does) the port's
speculation counters equal the JAX engine's."""
import numpy as np
import pytest

from repro.configs import get_smoke
from repro.core import SLO as JSLO
from repro.core import EngineConfig as JEngineConfig
from repro.core import Request as JRequest
from repro.core import make_policy
from repro.core.estimator import BatchLatencyEstimator as JEstimator
from repro.serving import Engine as JEngine
from repro.serving.spec import DraftRunner as JDraftRunner
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import SLO, EngineConfig, Request, SlideBatching
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Engine
from repro_torch.serving.spec import GAP_PREFILL, DraftRunner

from _torch_port_util import greedy_oracle, jax_tree, perturbed_numpy_params

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
TREE = perturbed_numpy_params(CFG)
DRAFT_TREE = perturbed_numpy_params(CFG, seed=7)     # an other-seed draft
TPARAMS = params_from_numpy(TREE, device="cpu")
TDRAFT = params_from_numpy(DRAFT_TREE, device="cpu")
# estimator coefficients of tools/perf_smoke.py's measure_spec: at tau =
# 1e9 the depth decisions do not depend on the measured step times
EST = dict(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3, t_c=1e-2)
COUNTERS = ("spec_proposed", "spec_accepted", "spec_rejected",
            "draft_launches", "spec_depth_hist", "decode_launches",
            "host_syncs", "packed_prefill_calls", "tokens_out")


@pytest.fixture(scope="module")
def oracle():
    return greedy_oracle(CFG, TREE)


def trace(n, plen, out_lo, out_hi, seed=0):
    """(output_len, prompt) pairs drawn once, so two engines get the same
    requests (``tests/test_spec_decode.py``'s ``_run``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        olen = int(rng.integers(out_lo, out_hi))
        out.append((olen, rng.integers(1, CFG.vocab, plen).astype(np.int32)))
    return out


def run_port(items, *, draft=None, spec_k=2, num_blocks=256, est=None,
             plen=48):
    eng = Engine(TCFG, TPARAMS,
                 EngineConfig(eta=1.0, w_p=4.0, tau=1e9, spec_k=spec_k),
                 SlideBatching(), num_blocks=num_blocks, block_size=16,
                 max_ctx=512, device="cpu",
                 est=BatchLatencyEstimator(**EST) if est else None,
                 spec_draft=(TCFG, draft) if spec_k else None)
    if est:
        eng.refit_every = 10 ** 9
    reqs = []
    for olen, prompt in items:
        r = Request(prompt_len=plen, output_len=olen, arrival=0.0,
                    slo=SLO(3600.0, 3600.0), priority=1)
        eng.add_request(r, prompt)
        reqs.append((r, prompt))
    eng.run_until_drained(max_iters=2000)
    outs = [eng.outputs[r.rid] for r, _ in reqs]
    eng.kill()
    return outs, eng


def run_jax(items, *, plen=48):
    eng = JEngine(CFG, jax_tree(TREE),
                  JEngineConfig(eta=1.0, w_p=4.0, tau=1e9, spec_k=2),
                  make_policy("slidebatching"), num_blocks=256,
                  block_size=16, max_ctx=512, est=JEstimator(**EST),
                  spec_draft=(CFG, jax_tree(TREE)))
    eng.refit_every = 10 ** 9
    reqs = []
    for olen, prompt in items:
        r = JRequest(prompt_len=plen, output_len=olen, arrival=0.0,
                     slo=JSLO(3600.0, 3600.0), priority=1)
        eng.add_request(r, prompt)
        reqs.append(r)
    eng.run_until_drained(max_iters=2000)
    outs = [eng.outputs[r.rid] for r in reqs]
    eng.kill()
    return outs, eng


def check_exact(outs, items, oracle):
    for got, (olen, prompt) in zip(outs, items):
        assert got == oracle(prompt, olen)


# ---------------------------------------------------------------------------
# the draft runner alone
# ---------------------------------------------------------------------------

def test_draft_runner_proposes_as_the_jax_runner():
    """Same weights, same calls: a prompt ingested by ``prefill_chunk``
    (gap > GAP_PREFILL), a short one fed by decode rounds, then a second
    engagement after ``observe`` (one proposal refuted) and a ``drop``."""
    rng = np.random.default_rng(3)
    seq_a = rng.integers(1, CFG.vocab, 40).astype(np.int32)
    seq_b = rng.integers(1, CFG.vocab, 5).astype(np.int32)
    assert len(seq_a) - 1 > GAP_PREFILL >= len(seq_b) - 1
    runners = (JDraftRunner(CFG, jax_tree(TREE), num_blocks=32,
                            max_ctx=256),
               DraftRunner(TCFG, TPARAMS, num_blocks=32, max_ctx=256,
                           device="cpu"))
    results = []
    for runner in runners:
        first = runner.propose([(1, seq_a, 2), (2, seq_b, 1)])
        counts = (runner.launches, runner.syncs)
        runner.observe(1, 2, 1)          # second proposal refuted
        runner.observe(2, 1, 1)
        ctx = dict(runner.ctx)
        a2 = np.concatenate([seq_a, [first[1][0], 11]]).astype(np.int32)
        b2 = np.concatenate([seq_b, [first[2][0], 12]]).astype(np.int32)
        second = runner.propose([(1, a2, 2), (2, b2, 2)])
        runner.drop(2)
        results.append((first, counts, ctx, second,
                        (runner.launches, runner.syncs), dict(runner.ctx),
                        sorted(runner.pool.tables)))
    jax_res, port_res = results
    assert port_res == jax_res
    # one ingest; five decode rounds feed the short prompt and its proposal
    assert jax_res[1] == (1 + 5, 5)


# ---------------------------------------------------------------------------
# spec-on engine streams against greedy decoding
# ---------------------------------------------------------------------------

ITEMS = trace(6, 48, 3, 9)


@pytest.mark.parametrize("draft", ["same", "other"])
def test_spec_streams_equal_greedy_forward(draft, oracle):
    outs, eng = run_port(ITEMS, draft=TPARAMS if draft == "same" else TDRAFT)
    check_exact(outs, ITEMS, oracle)
    st = eng.stats
    assert st.spec_proposed > 0
    assert st.spec_proposed == st.spec_accepted + st.spec_rejected
    assert st.host_syncs == (st.decode_launches + st.packed_prefill_calls
                             + eng.draft.syncs)
    assert st.draft_launches == eng.draft.launches
    if draft == "same":
        assert st.spec_accepted == st.spec_proposed
        assert max(st.spec_depth_hist) == 2       # priority 1: full depth
    else:
        assert st.spec_rejected > 0
        # rejections collapse the depth toward 0
        assert st.spec_depth_hist.get(0, 0) > 0


def test_spec_preemption_mid_stream_exact(oracle):
    """Memory pressure evicts requests with live draft state: they drop
    it, re-engage after reload and still emit the greedy stream."""
    items = trace(8, 48, 6, 12)
    outs, eng = run_port(items, draft=TPARAMS, num_blocks=28)
    check_exact(outs, items, oracle)
    assert eng.stats.evictions > 0, "the pool must force preemption"
    assert eng.stats.spec_proposed > 0
    assert not eng.draft.ctx and not eng.draft.pool.tables


# ---------------------------------------------------------------------------
# counters against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frozen_runs():
    items = trace(4, 32, 8, 14, seed=1)
    j_outs, j_eng = run_jax(items, plen=32)
    p_outs, p_eng = run_port(items, draft=TPARAMS, est=True, plen=32)
    return items, (j_outs, j_eng), (p_outs, p_eng)


def test_spec_counters_equal_the_jax_engine(frozen_runs):
    items, (j_outs, j_eng), (p_outs, p_eng) = frozen_runs
    assert p_outs == j_outs
    for name in COUNTERS:
        assert getattr(p_eng.stats, name) == getattr(j_eng.stats, name), name
    assert p_eng.stats.spec_proposed > 0
    assert (p_eng.draft.launches, p_eng.draft.syncs) == (
        j_eng.draft.launches, j_eng.draft.syncs)


def test_spec_takes_fewer_target_launches_than_plain_decode(frozen_runs):
    items, _, (p_outs, p_eng) = frozen_runs
    plain_outs, plain = run_port(items, spec_k=0, est=True, plen=32)
    assert plain_outs == p_outs
    st = p_eng.stats
    assert st.decode_launches < plain.stats.decode_launches
