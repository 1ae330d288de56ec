"""The port's ``ServiceController`` over ``Engine(device="cpu")`` replicas
on the reference's scenarios, against greedy decoding by the JAX
package's ``forward`` on the same parameters: the five churn kills of
``tests/test_disagg.py`` (a replica dies at each phase of the two-leg
lifecycle and every stream still comes out exact, no token lost or
duplicated) and the two service scenarios of ``tests/test_engine_real.py``
(failover, elastic add and graceful remove); and the fleet path of the
port's serve entry point (``--pd disagg`` / ``--pd coloc``)."""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import (SLO, EngineConfig, GoRouting, Request,
                              RouterConfig, make_policy)
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Engine, ServiceController

from _torch_port_util import greedy_oracle

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
TREE = jax.tree.map(np.asarray, jax_init_params(CFG, jax.random.PRNGKey(0)))
TPARAMS = params_from_numpy(TREE, device="cpu")
SLO_LOOSE = SLO(3600.0, 3600.0)
PLEN = 24
SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def oracle():
    return greedy_oracle(CFG, TREE)


def make_engine(role="coloc", *, prefix_cache=True, num_blocks=128):
    return Engine(TCFG, TPARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  make_policy("slidebatching"), num_blocks=num_blocks,
                  block_size=16, max_ctx=256, role=role,
                  prefix_cache=prefix_cache, device="cpu")


def make_controller(pd_mode="disagg", **est_kw):
    est = BatchLatencyEstimator(**(est_kw or dict(
        a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3, t_c=1e-2)))
    return ServiceController(GoRouting(est, RouterConfig(pd_mode=pd_mode)),
                             est)


def kill_all(svc, *engines):
    for eng in (*svc.engines.values(), *engines):
        eng.kill()


# ---------------------------------------------------------------------------
# churn: kill replicas at every phase of the two-leg lifecycle
# ---------------------------------------------------------------------------

def churn_fleet():
    """prefill + decode + coloc: the failover target must exist."""
    svc = make_controller()
    pe = make_engine("prefill", prefix_cache=False)
    de = make_engine("decode", prefix_cache=False)
    ce = make_engine("coloc", prefix_cache=False)
    iids = [svc.add_instance(e) for e in (pe, de, ce)]
    return svc, (pe, de, ce), iids


def submit_cases(svc, oracle, n=3, olen=6):
    cases = []
    for s in SEEDS[:n]:
        p = np.random.default_rng(s).integers(1, CFG.vocab, PLEN) \
            .astype(np.int32)
        r = Request(prompt_len=PLEN, output_len=olen, arrival=0.0,
                    slo=SLO_LOOSE, priority=1)
        svc.submit(r, p)
        cases.append((r, oracle(p, olen)))
    return cases


def assert_exact_streams(svc, cases):
    assert len(svc.finished) == len(cases)
    assert sorted(r.rid for r in svc.finished) == sorted(r.rid
                                                         for r, _ in cases)
    by_rid = {}
    for e in svc.engines.values():
        by_rid.update(e.outputs)
    for r, want in cases:
        got = by_rid.get(r.rid)
        assert got == want, f"rid {r.rid}: {got} != {want}"
        assert r.generated == len(want)


def test_churn_decode_dies_before_any_handoff(oracle):
    """Decode replica dies while every request is still prefilling: the
    exported payloads find no decode capacity and fail over to a full
    re-prefill on the coloc replica — exact streams, nothing lost."""
    svc, (pe, de, ce), (ip, idd, ic) = churn_fleet()
    cases = submit_cases(svc, oracle)
    svc.kill_instance(idd)
    svc.serve_until_drained()
    assert_exact_streams(svc, cases)
    assert svc.book.reservations == {}
    assert svc.book.handoffs == 0
    assert all(r.rid in ce.outputs for r, _ in cases)
    kill_all(svc)


def test_churn_decode_dies_mid_handoff(oracle):
    """Decode replica dies in the export window (D2H copy in flight /
    payload undelivered): failover re-prefills on the coloc replica with
    the already-streamed first token as the durable prefix — no token is
    lost or duplicated."""
    svc, (pe, de, ce), (ip, idd, ic) = churn_fleet()
    cases = submit_cases(svc, oracle)
    for _ in range(500):
        svc.step_all()
        if pe.stats.handoffs_out or pe._handoff_wait:
            break
    else:
        pytest.fail("prefill never reached the export window")
    svc.kill_instance(idd)
    svc.serve_until_drained()
    assert_exact_streams(svc, cases)
    assert svc.book.reservations == {}
    for st in svc.book.states.values():
        assert st.reserved_blocks == 0
    kill_all(svc)


def test_churn_decode_dies_after_adoption(oracle):
    """Decode replica dies mid-decode (payload adopted, tokens flowing):
    orphans resume from the durable log on the coloc replica, continuing
    exactly where the dead replica stopped."""
    svc, (pe, de, ce), (ip, idd, ic) = churn_fleet()
    cases = submit_cases(svc, oracle, olen=8)
    for _ in range(500):
        svc.step_all()
        if any(len(de.outputs.get(r.rid, [])) >= 2 for r, _ in cases):
            break
    else:
        pytest.fail("decode replica never got past token 2")
    assert svc.book.handoffs > 0
    svc.kill_instance(idd)
    svc.serve_until_drained()
    assert_exact_streams(svc, cases)
    kill_all(svc)


def test_churn_prefill_dies_mid_chunk(oracle):
    """Prefill replica dies with prompts partially prefilled: requests
    re-dispatch (KV lost, recomputed) and finish exactly wherever they
    land."""
    svc, (pe, de, ce), (ip, idd, ic) = churn_fleet()
    cases = submit_cases(svc, oracle)
    svc.step_all()
    svc.kill_instance(ip)
    svc.serve_until_drained()
    assert_exact_streams(svc, cases)
    for st in svc.book.states.values():
        assert st.reserved_blocks == 0
    kill_all(svc)


def test_churn_both_legs_die(oracle):
    """Prefill AND decode replicas die at different phases; the coloc
    survivor finishes everything exactly."""
    svc, (pe, de, ce), (ip, idd, ic) = churn_fleet()
    cases = submit_cases(svc, oracle)
    svc.step_all()
    svc.kill_instance(ip)
    svc.step_all()
    svc.kill_instance(idd)
    svc.serve_until_drained()
    assert_exact_streams(svc, cases)
    assert all(r.rid in ce.outputs for r, _ in cases)
    kill_all(svc)


# ---------------------------------------------------------------------------
# service scenarios of tests/test_engine_real.py (coloc fleet)
# ---------------------------------------------------------------------------

def test_service_failover_completes_all(oracle):
    rng = np.random.default_rng(0)
    svc = make_controller("coloc")
    e0, e1 = make_engine(), make_engine()
    i0 = svc.add_instance(e0)
    svc.add_instance(e1)
    reqs = []
    for k in range(6):
        r = Request(prompt_len=20, output_len=3, arrival=0.0,
                    slo=SLO_LOOSE, priority=1 + k % 2)
        prompt = rng.integers(1, CFG.vocab, 20).astype(np.int32)
        svc.submit(r, prompt)
        reqs.append((r, oracle(prompt, 3)))
    svc.step_all()
    assert e0.queue, "the killed replica must hold work"
    svc.kill_instance(i0)
    svc.serve_until_drained()
    assert len(svc.finished) == 6
    eng_by_rid = {}
    for e in svc.engines.values():
        eng_by_rid.update(e.outputs)
    for r, want in reqs:
        got = eng_by_rid.get(r.rid) or e0.outputs.get(r.rid)
        assert got == want
    kill_all(svc, e0)


def test_service_elastic_add_and_graceful_remove(oracle):
    rng = np.random.default_rng(1)
    svc = make_controller("coloc", c_p=1e-4, b_d=1e-3, t_c=1e-2)
    e0 = make_engine()
    i0 = svc.add_instance(e0)
    reqs = []

    def submit():
        r = Request(prompt_len=16, output_len=2, arrival=0.0,
                    slo=SLO_LOOSE)
        prompt = rng.integers(1, CFG.vocab, 16).astype(np.int32)
        svc.submit(r, prompt)
        reqs.append((r, oracle(prompt, 2)))

    for _ in range(4):
        submit()
    e1 = make_engine()
    i1 = svc.add_instance(e1)
    assert i1 != i0 and i1 in svc.states
    for _ in range(2):
        submit()
    svc.remove_instance(i0, drain=True)
    assert i0 not in svc.engines and i0 not in svc.states
    svc.serve_until_drained()
    assert len(svc.finished) == 6
    for r, want in reqs:
        assert e1.outputs[r.rid] == want
    kill_all(svc, e0)


# ---------------------------------------------------------------------------
# the serve entry point's fleet path
# ---------------------------------------------------------------------------

def check_fleet(res, oracle):
    outputs = res.outputs
    for r, prompt in res.requests:
        assert outputs[r.rid] == oracle(prompt, r.output_len), \
            f"rid {r.rid} diverged"
        assert r.generated == r.output_len


def check_book(res):
    """Every handoff settled its reservation, nothing stands reserved,
    and the book's blocks are the engines' own.  Reservations are capped
    at a decode replica's capacity (a zero-block miss beyond it), so
    reserved == adopted only when every reservation was a hit."""
    s, book = res.summary(), res.controller.book
    assert s["handoffs_out"] == s["handoffs_in"] == s["handoffs"]
    assert s["handoff_blocks_out"] == s["handoff_blocks"] == \
        s["adopted_blocks_total"]
    assert s["reservation_hits"] + s["reservation_misses"] == s["handoffs"]
    assert s["reserved_blocks_total"] <= s["adopted_blocks_total"]
    if s["reservation_misses"] == 0:
        assert s["reserved_blocks_total"] == s["adopted_blocks_total"]
    assert book.reservations == {}
    assert all(st.reserved_blocks == 0 for st in book.states.values())
    for e in res.controller.engines.values():
        assert e.bm.used_blocks == 0
        assert not e._handoff_wait and not e._handoff_ready
        for tier in (e.pool.tier.hot, e.pool.tier.cold):
            assert not [rid for rid in tier if rid >= 0]
    return s


@pytest.mark.parametrize("roles,pd_mode,int8", [
    (("prefill", "decode"), "disagg", False),
    (("prefill", "decode"), "disagg", True),
    (("prefill", "decode", "decode"), "disagg", False),
    (("coloc", "coloc"), "coloc", False)],
    ids=["1p1d", "1p1d-int8", "1p2d", "coloc-2"])
def test_serve_fleet_streams_equal_greedy_forward(roles, pd_mode, int8,
                                                  oracle):
    """The two-wave smoke traffic (a 28-block pool per replica, below the
    demand) through the fleet: every stream equals greedy forward (the
    int8 wire survives on this traffic), every request with more than one
    output token crosses the handoff in a disagg fleet, the replicas
    share one params dict, and nothing leaks."""
    res = serve.serve_fleet(TCFG, TPARAMS, serve.SMOKE, roles=roles,
                            pd_mode=pd_mode, seed=3, device="cpu",
                            handoff_int8=int8)
    check_fleet(res, oracle)
    assert all(e.params is TPARAMS for e in res.replicas)
    s = check_book(res)
    assert s["requests"] == 12 and s["transfer_failures"] == 0
    if pd_mode == "disagg":
        assert s["handoffs"] == 12
        block = res.replicas[0].pool.tier.block_bytes
        if int8:
            assert s["handoff_bytes_out"] < s["handoff_blocks_out"] * block
        else:
            assert s["handoff_bytes_out"] == s["handoff_blocks_out"] * block
    else:
        assert s["handoffs"] == 0
        assert all(e.stats.tokens_out for e in res.replicas)
    for e in res.replicas:
        e.kill()


def test_serve_fleet_churn_kills_decode_after_first_adoption(oracle):
    """prefill + decode + coloc: the decode replica is killed after its
    first adoption; every stream is still exact, with each output token
    emitted once."""
    killed = []

    def after_round(ctl):
        for iid, eng in list(ctl.engines.items()):
            if eng.role == "decode" and eng.stats.handoffs_in and not killed:
                killed.append(iid)
                ctl.kill_instance(iid)

    res = serve.serve_fleet(TCFG, TPARAMS, serve.SMOKE,
                            roles=("prefill", "decode", "coloc"),
                            pd_mode="disagg", seed=3, device="cpu",
                            after_round=after_round)
    assert killed and res.summary()["killed"] == killed
    check_fleet(res, oracle)
    assert sum(len(res.emitted[r.rid]) for r, _ in res.requests) == \
        12 * serve.SMOKE.output_len
    for e in res.replicas:
        e.kill()


def test_serve_entry_point_fleet_equals_single_engine(capsys):
    """``--pd disagg`` and ``--pd coloc`` through ``serve.main`` on the
    port's own weights: the same streams as the single engine (disagg =
    coloc), and the summary line carries the handoff and reservation
    counters."""
    base = ["--smoke", "--device", "cpu", "--seed", "1"]
    single = serve.main(base)
    want = [single.outputs[r.rid] for r, _ in single.requests]
    single.engine.kill()
    for extra in (["--pd", "disagg", "--instances", "1",
                   "--decode-instances", "1"],
                  ["--pd", "coloc", "--instances", "2"]):
        capsys.readouterr()
        res = serve.main(base + extra)
        line = capsys.readouterr().out
        assert '"handoffs_out"' in line and '"reservation_hits"' in line
        assert [res.outputs[r.rid] for r, _ in res.requests] == want
        check_book(res)
        for e in res.replicas:
            e.kill()
    with pytest.raises(SystemExit):
        serve.main(base + ["--instances", "2"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--pd", "coloc", "--handoff-int8"])
