"""The port's async service tier — ``ServiceFrontend`` over threaded
``EngineDriver``s of ``Engine(device="cpu")`` replicas — on the eight
scenarios of ``tests/test_frontend.py``, every stream held against greedy
decoding by the JAX package's ``forward`` on the same (perturbed)
parameters; plus what the port adds: a driver thread that raises fails
its streams and ``drain`` / ``stop`` at once instead of hanging, and the
launcher's ``--mode frontend`` path (coloc with a kill, disagg) exact."""
import asyncio
import threading

import numpy as np
import pytest

from repro.configs import get_smoke
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import (SLO, EngineConfig, GoRouting, Request,
                              RouterConfig, make_policy)
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (AdmissionError, DriverDied, Engine,
                                 FrontendConfig, ServiceFrontend)
from repro_torch.sim import (AnalyticalExecutor, ClusterConfig, ClusterSim,
                             InstanceHardware, QWEN2_7B, clip_lengths,
                             replay_sim, summarize)
from repro_torch.sim.workloads import sharegpt

from _torch_port_util import greedy_oracle, perturbed_numpy_params

CFG = get_smoke("qwen1_5_0_5b")
TCFG = t_get_smoke("qwen1_5_0_5b")
TREE = perturbed_numpy_params(CFG, seed=0)
TPARAMS = params_from_numpy(TREE, device="cpu")
RNG = np.random.default_rng(0)
SLO_LOOSE = SLO(3600.0, 3600.0)
EST = dict(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3, t_c=1e-2)


@pytest.fixture(scope="module")
def oracle():
    return greedy_oracle(CFG, TREE)


def make_engine(num_blocks=160, role="coloc", prefix_cache=True):
    return Engine(TCFG, TPARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  make_policy("slidebatching"), num_blocks=num_blocks,
                  block_size=16, max_ctx=256, role=role,
                  prefix_cache=prefix_cache, device="cpu")


def make_frontend(n_replicas=2, **cfg_kwargs):
    est = BatchLatencyEstimator(**EST)
    fe = ServiceFrontend(GoRouting(est, RouterConfig(pd_mode="coloc")), est,
                         FrontendConfig(**cfg_kwargs))
    for _ in range(n_replicas):
        fe.add_instance(make_engine())
    return fe


def stop_engines(fe):
    for eng in (*fe.engines.values(),
                *(d.engine for d in fe.killed.values())):
        eng.kill()


def test_concurrent_streams_across_two_replicas(oracle):
    """64 concurrent streaming requests of 2 priorities through 2 engine
    replicas, measured at the client; every stream exact."""
    async def run():
        fe = make_frontend(n_replicas=2, max_inflight=128)
        await fe.start()
        cases = []
        for k in range(64):
            plen = int(RNG.integers(8, 32))
            r = Request(prompt_len=plen, output_len=3, arrival=0.0,
                        slo=SLO_LOOSE, priority=1 + k % 2,
                        weight=2.0 if k % 2 == 0 else 1.0)
            prompt = RNG.integers(1, CFG.vocab, plen).astype(np.int32)
            cases.append((prompt, await fe.submit(r, prompt)))
        await asyncio.gather(*[s.collect() for _, s in cases])
        await fe.stop()
        return fe, cases

    fe, cases = asyncio.run(run())
    assert len(fe.finished) == 64
    for prompt, s in cases:
        assert s.done and s.tokens == oracle(prompt, 3)
        assert s.ttft is not None and s.ttft > 0
        assert s.tpot is not None and s.tpot > 0
    per_engine = [e.stats.tokens_out for e in fe.engines.values()]
    assert len(per_engine) == 2 and all(t > 0 for t in per_engine)
    assert sum(per_engine) == 64 * 3
    summ = summarize(fe.client_edge_requests(), w_p=4.0)
    assert set(summ.per_priority) == {1, 2}
    assert summ.n == 64
    stop_engines(fe)


def test_stream_ordering_and_event_flags(oracle):
    async def run():
        fe = make_frontend(n_replicas=2)
        await fe.start()
        events, streams, prompts = {}, {}, {}
        for k in range(8):
            r = Request(prompt_len=12, output_len=4, arrival=0.0,
                        slo=SLO_LOOSE, priority=1 + k % 2)
            prompt = RNG.integers(1, CFG.vocab, 12).astype(np.int32)
            streams[r.rid] = await fe.submit(r, prompt)
            prompts[r.rid] = prompt
            events[r.rid] = []

        async def consume(rid, s):
            async for ev in s:
                assert ev.rid == rid
                events[rid].append(ev)

        await asyncio.gather(*[consume(rid, s)
                               for rid, s in streams.items()])
        await fe.stop()
        return fe, events, streams, prompts

    fe, events, streams, prompts = asyncio.run(run())
    for rid, evs in events.items():
        assert [e.index for e in evs] == list(range(1, 5))
        assert evs[0].first and not any(e.first for e in evs[1:])
        assert evs[-1].last and not any(e.last for e in evs[:-1])
        wall = [e.t_wall for e in evs]
        assert wall == sorted(wall)
        assert streams[rid].tokens == [e.token for e in evs]
        assert streams[rid].tokens == oracle(prompts[rid], 4)
    stop_engines(fe)


def test_admission_rejection_and_backpressure(oracle):
    """The reference's scenario; the replica steps only once the waiter
    has been seen blocked (a CPU torch step can finish the first
    request inside the reference's 50 ms probe window)."""
    async def run():
        fe = make_frontend(n_replicas=1,
                           max_inflight=4, priority_quota={1: 1, 2: 2})
        eng, gate = fe.engines[0], threading.Event()
        real_step = eng.step

        def gated_step():
            assert gate.wait(60.0)
            return real_step()

        eng.step = gated_step
        await fe.start()

        def req(prio, out=2):
            return Request(prompt_len=8, output_len=out, arrival=0.0,
                           slo=SLO_LOOSE, priority=prio)

        p8 = RNG.integers(1, CFG.vocab, 8).astype(np.int32)
        s1 = await fe.submit(req(1), p8)
        with pytest.raises(AdmissionError) as ei:
            await fe.submit(req(1), p8)
        assert ei.value.priority == 1 and ei.value.limit == 1
        s2 = await fe.submit(req(2), p8)
        assert fe.rejected == 1

        waiter = asyncio.ensure_future(fe.submit(req(1), p8, wait=True))
        await asyncio.sleep(0.05)
        assert not waiter.done()          # still blocked on the quota
        gate.set()
        await asyncio.gather(s1.collect(), s2.collect())
        s3 = await asyncio.wait_for(waiter, timeout=60.0)
        await s3.collect()
        assert await fe.drain()
        await fe.stop()
        return fe, p8, (s1, s2, s3)

    fe, p8, streams = asyncio.run(run())
    assert len(fe.finished) == 3
    for s in streams:
        assert s.tokens == oracle(p8, 2)
    stop_engines(fe)


def wait_first_tokens(cases):
    async def wait():
        deadline = asyncio.get_running_loop().time() + 120.0
        while any(not s.recv_times for _, _, s in cases):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.005)
    return wait()


def test_frontend_failover_resumes_streams_exactly(oracle):
    """Kill a replica mid-generation: orphans re-dispatch with their
    streamed prefix and every client stream is still exact."""
    async def run():
        fe = make_frontend(n_replicas=2)
        await fe.start()
        cases = []
        for _ in range(6):
            plen = int(RNG.integers(8, 24))
            prompt = RNG.integers(1, CFG.vocab, plen).astype(np.int32)
            r = Request(prompt_len=plen, output_len=8, arrival=0.0,
                        slo=SLO_LOOSE, priority=1)
            cases.append((r, prompt, await fe.submit(r, prompt)))
        tasks = [asyncio.ensure_future(s.collect()) for _, _, s in cases]
        await wait_first_tokens(cases)
        fe.kill_instance(0)
        await asyncio.gather(*tasks)
        await fe.stop()
        return fe, cases

    fe, cases = asyncio.run(run())
    for r, prompt, s in cases:
        assert s.tokens == oracle(prompt, 8), \
            f"rid {r.rid} diverged across failover"
    stop_engines(fe)


def make_disagg_frontend(*, coloc=True, **cfg_kwargs):
    est = BatchLatencyEstimator(**EST)
    fe = ServiceFrontend(GoRouting(est, RouterConfig(pd_mode="disagg")),
                         est, FrontendConfig(**cfg_kwargs))
    roles = ["prefill", "decode"] + (["coloc"] if coloc else [])
    iids = {role: fe.add_instance(make_engine(role=role,
                                              prefix_cache=False))
            for role in roles}
    return fe, iids


async def disagg_cases(fe, n=4, olen=8):
    cases = []
    for _ in range(n):
        plen = int(RNG.integers(12, 28))
        prompt = RNG.integers(1, CFG.vocab, plen).astype(np.int32)
        r = Request(prompt_len=plen, output_len=olen, arrival=0.0,
                    slo=SLO_LOOSE, priority=1)
        cases.append((r, prompt, await fe.submit(r, prompt)))
    return cases


def test_frontend_disagg_two_leg_streams_exact(oracle):
    async def run():
        fe, iids = make_disagg_frontend(coloc=False)
        await fe.start()
        cases = await disagg_cases(fe)
        await asyncio.gather(*[s.collect() for _, _, s in cases])
        await fe.stop()
        return fe, cases

    fe, cases = asyncio.run(run())
    for r, prompt, s in cases:
        assert s.tokens == oracle(prompt, 8), \
            f"rid {r.rid} diverged across the handoff"
    book = fe.book
    assert book.handoffs == len(cases)
    assert book.reservation_misses == 0
    assert book.reserved_blocks_total == book.adopted_blocks_total
    assert book.reservations == {}
    for st in book.states.values():
        assert st.reserved_blocks == 0
    stop_engines(fe)


def test_frontend_churn_decode_replica_dies_mid_handoff(oracle):
    async def run():
        fe, iids = make_disagg_frontend()
        await fe.start()
        cases = await disagg_cases(fe)
        tasks = [asyncio.ensure_future(s.collect()) for _, _, s in cases]
        await wait_first_tokens(cases)
        fe.kill_instance(iids["decode"])
        await asyncio.gather(*tasks)
        await fe.stop()
        return fe, cases

    fe, cases = asyncio.run(run())
    assert len(fe.finished) == len(cases)
    for r, prompt, s in cases:
        assert len(s.tokens) == 8          # nothing lost, nothing doubled
        assert s.tokens == oracle(prompt, 8), \
            f"rid {r.rid} diverged across decode-replica death"
    assert fe.book.reservations == {}
    for st in fe.book.states.values():
        assert st.reserved_blocks == 0
    stop_engines(fe)


def test_frontend_churn_prefill_replica_dies_mid_chunk(oracle):
    async def run():
        fe, iids = make_disagg_frontend()
        await fe.start()
        cases = await disagg_cases(fe)
        tasks = [asyncio.ensure_future(s.collect()) for _, _, s in cases]
        await asyncio.sleep(0.01)          # let prefill chunks start
        fe.kill_instance(iids["prefill"])
        await asyncio.gather(*tasks)
        await fe.stop()
        return fe, cases

    fe, cases = asyncio.run(run())
    assert len(fe.finished) == len(cases)
    for r, prompt, s in cases:
        assert s.tokens == oracle(prompt, 8), \
            f"rid {r.rid} diverged across prefill-replica death"
    stop_engines(fe)


def test_replay_sim_deterministic_and_per_priority():
    ex = AnalyticalExecutor(QWEN2_7B, InstanceHardware(chips=4))
    est, mape = ex.fit_estimator(n=200)
    assert mape < 0.15

    def run_once():
        reqs = clip_lengths(sharegpt(rate=30, duration=4, seed=3),
                            max_in=512, max_out=64)
        cs = ClusterSim(lambda: make_policy("slidebatching"),
                        GoRouting(est, RouterConfig(pd_mode="coloc")),
                        ex, est, EngineConfig(w_p=4.0),
                        ClusterConfig(pd_mode="coloc", n_prefill=2))
        return replay_sim(cs, reqs, w_p=4.0)

    a, b = run_once(), run_once()
    row_a = {k: v for k, v in a.row().items() if k != "wall_s"}
    row_b = {k: v for k, v in b.row().items() if k != "wall_s"}
    assert row_a == row_b
    assert a.n_completed == a.n_submitted
    assert set(a.per_priority) == {1, 2}
    for m in a.per_priority.values():
        assert 0.0 <= m["slo"] <= 1.0 and m["tdg_ratio"] >= 0.0


# ---------------------------------------------------------------------------
# what the port adds
# ---------------------------------------------------------------------------

def test_many_drivers_under_a_short_switch_interval(oracle):
    """Eight driver threads (more than the workers' cores) and the event
    loop share the book, the request log and the stream maps under a
    1 us switch interval: every stream still gets exactly its tokens,
    each emitted once, and the admission counters return to zero."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        async def run():
            fe = make_frontend(n_replicas=8, max_inflight=64)
            await fe.start()
            cases = []
            for k in range(48):
                plen = int(RNG.integers(8, 40))
                prompt = RNG.integers(1, CFG.vocab, plen).astype(np.int32)
                r = Request(prompt_len=plen, output_len=4, arrival=0.0,
                            slo=SLO_LOOSE, priority=1 + k % 3)
                cases.append((prompt, await fe.submit(r, prompt)))
            await asyncio.wait_for(
                asyncio.gather(*[s.collect() for _, s in cases]), 120.0)
            assert await fe.drain(timeout=60.0)
            await fe.stop()
            return fe, cases

        fe, cases = asyncio.run(run())
    finally:
        sys.setswitchinterval(old)
    for prompt, s in cases:
        assert s.tokens == oracle(prompt, 4)
    assert sum(e.stats.tokens_out for e in fe.engines.values()) == 48 * 4
    assert fe._total_inflight == 0 and not any(fe._inflight.values())
    assert len(fe.finished) == 48 and fe.book.request_log == {}
    assert all(not d._thread.is_alive() for d in fe.drivers.values())
    stop_engines(fe)


def test_a_dead_driver_fails_its_streams_and_drain_at_once():
    """A driver thread that raises (a CUDA error, say) closes the streams
    it held with that error, and ``drain`` / ``stop`` raise ``DriverDied``
    with it as the cause — nothing waits for the timeout."""
    async def run():
        fe = make_frontend(n_replicas=1)
        eng = fe.engines[0]
        real_step = eng.step
        calls = []

        def failing_step():
            calls.append(threading.current_thread().name)
            if eng.queue:
                raise RuntimeError("CUDA error: an illegal memory access")
            return real_step()

        eng.step = failing_step
        await fe.start()
        p = RNG.integers(1, CFG.vocab, 12).astype(np.int32)
        r = Request(prompt_len=12, output_len=6, arrival=0.0,
                    slo=SLO_LOOSE, priority=1)
        s = await fe.submit(r, p)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            await asyncio.wait_for(s.collect(), timeout=30.0)
        t0 = asyncio.get_running_loop().time()
        with pytest.raises(DriverDied) as ei:
            await fe.drain(timeout=60.0)
        assert asyncio.get_running_loop().time() - t0 < 5.0
        assert "illegal memory access" in str(ei.value.__cause__)
        with pytest.raises(DriverDied):
            await fe.stop()
        with pytest.raises(DriverDied):
            fe.drivers[0].join_idle(timeout=1.0)
        assert calls[0] == "engine-driver-0"
        assert fe.drivers[0].error is not None
        assert not fe.drivers[0]._thread.is_alive()
        return fe

    stop_engines(asyncio.run(run()))


@pytest.mark.parametrize("mode", ["coloc_kill", "disagg"])
def test_serve_frontend_mode_streams_exact(oracle, mode):
    """The launcher's ``--mode frontend`` path at smoke width on the CPU:
    the industrial trace's streams equal the JAX greedy oracle, every
    token emitted once, the two-leg accounting settles (disagg) and
    every orphan of a killed replica completes (coloc)."""
    from repro_torch.launch import serve

    kw = (dict(roles=("coloc", "coloc"), pd_mode="coloc", kill=0)
          if mode == "coloc_kill" else
          dict(roles=("prefill", "decode", "decode"), pd_mode="disagg"))
    res = serve.serve_frontend(TCFG, TPARAMS, serve.REPLAY_SMOKE,
                               device="cpu", **kw)
    s = res.summary()
    assert res.drained and s["completed"] == s["submitted"] == 16
    assert {r.priority for r, _ in res.requests} == {1, 2, 3}
    for r, prompt in res.requests:
        assert res.outputs[r.rid] == oracle(prompt, r.output_len), r.rid
    assert s["tokens_out"] == sum(r.output_len for r, _ in res.requests)
    if mode == "disagg":
        crossing = sum(r.output_len > 1 for r, _ in res.requests)
        assert s["handoffs_out"] == s["handoffs_in"] == s["handoffs"] \
            == crossing
        assert res.frontend.book.reservations == {}
    else:
        assert s["killed"] == [0] and res.orphans
        assert all(r.generated == r.output_len for r in res.orphans)
    for eng in res.replicas:
        eng.kill()
