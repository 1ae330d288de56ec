"""The port's copy of the scheduling core plans exactly what the JAX
package's core plans: the same scheduling scenarios, driven through
``repro.core`` and ``repro_torch.core``, give identical BatchPlans
(entries, chunk sizes, evictions, copy budgets) step by step, under
SlideBatching and every baseline policy of ``make_policy``; and the same
routing sequence through ``repro.serving.dispatch.RouterBook`` (GoRouting
and the baseline routers, coloc and disagg) and the port's copy gives the
same picks, reservations, instance states and counters."""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import make_policy
from repro.serving.dispatch import RouterBook as JRouterBook
from repro_torch.serving.dispatch import RouterBook as TRouterBook


def drive(core, policy, scenario, max_steps=3000):
    """Run a scenario on one core: requests arrive at their times, every
    plan is applied as the simulator applies it (prefill progress,
    first-token emission, decode tokens, release on finish) with a fixed
    step latency.  Returns the plans as comparable tuples."""
    bm = core.BlockManager(scenario["blocks"], 16, 2e-3,
                           **scenario.get("bm", {}))
    est = core.BatchLatencyEstimator(a_p=1e-7, b_p=1e-7, c_p=2e-4,
                                     a_d=1e-7, b_d=1e-3, t_c=5e-3)
    cfg = core.EngineConfig(**scenario.get("cfg", {}))
    reqs = []
    for i, (arr, plen, olen, prio, w) in enumerate(scenario["reqs"]):
        reqs.append(core.Request(
            prompt_len=plen, output_len=olen, arrival=arr,
            slo=core.SLO(*scenario.get("slo", (0.5, 0.05))), priority=prio,
            weight=w))
    index = {r.rid: i for i, r in enumerate(reqs)}
    queue, pending, now, log = [], list(reqs), 0.0, []
    for _ in range(max_steps):
        while pending and pending[0].arrival <= now:
            queue.append(pending.pop(0))
        if not queue and not pending:
            break
        bm.complete_offloads(now)
        plan = policy.form_batch(core.SchedView(queue, bm, est, cfg, now))
        log.append((
            tuple((index[e.req.rid], e.n_tokens, e.l_kv, e.is_prefill,
                   e.depth) for e in plan.entries),
            tuple(index[r.rid] for r in plan.evictions),
            round(plan.est_time, 12), plan.copy_blocks))
        if not plan.entries:
            now = pending[0].arrival if pending else now + 0.01
            continue
        end = now + 0.02 + 1e-4 * sum(e.n_tokens for e in plan.entries)
        for e in plan.entries:
            r, s = e.req, bm.state(e.req)
            if e.is_prefill:
                if r.generated == 0 and s.dev_tokens >= r.prompt_len:
                    r.emit_token(end)
            else:
                r.emit_token(end)
            if r.finish_time is not None:
                bm.release(r)
        queue = [r for r in queue if r.finish_time is None]
        now = end
    assert not queue and not pending, "scenario did not drain"
    return log


def scenarios():
    rng = np.random.default_rng(3)

    def mix(n, t_span, plen, olen):
        out = []
        for i in range(n):
            prio = 1 + i % 3
            out.append((float(rng.uniform(0, t_span)),
                        int(rng.integers(*plen)), int(rng.integers(*olen)),
                        prio, {1: 3.0, 2: 2.0, 3: 1.0}[prio]))
        return sorted(out)

    return {
        "roomy": dict(blocks=512, reqs=mix(10, 0.5, (16, 300), (2, 30))),
        "pressure": dict(blocks=40, reqs=mix(12, 0.3, (40, 200), (4, 40))),
        "sync_offload": dict(blocks=40, bm=dict(async_offload=False),
                             reqs=mix(10, 0.3, (40, 200), (4, 30))),
        "recompute_only": dict(blocks=40, bm=dict(recompute_only=True),
                               reqs=mix(10, 0.3, (40, 200), (4, 30))),
        "starvation": dict(blocks=160, cfg=dict(tau=0.2, eta=0.02),
                           slo=(0.2, 0.02),
                           reqs=mix(14, 1.0, (30, 250), (5, 60))),
    }


@pytest.mark.parametrize("name", list(scenarios()))
def test_same_plans_through_both_cores(name):
    sc = scenarios()[name]
    want = drive(jcore, make_policy("slidebatching"), sc)
    got = drive(tcore, tcore.SlideBatching(), sc)
    assert len(got) == len(want)
    assert got == want
    if name in ("pressure", "sync_offload", "recompute_only"):
        assert any(ev for _, ev, _, _ in want), "scenario needs evictions"


@pytest.mark.parametrize("name", list(scenarios()))
@pytest.mark.parametrize("policy", sorted(jcore.POLICIES))
def test_baseline_policies_plan_identically(policy, name):
    sc = scenarios()[name]
    want = drive(jcore, jcore.make_policy(policy), sc)
    got = drive(tcore, tcore.make_policy(policy), sc)
    assert got == want
    assert sorted(tcore.POLICIES) == sorted(jcore.POLICIES)


def route_log(core, book_cls, router_name, pd_mode, seed):
    """A fleet's router-side life without engines: requests arrive and
    are routed (prefix-sharing prompts feed the affinity registry), steps
    report free blocks and latencies, prefill legs finish or export,
    handoffs are delivered (some to another decode replica than the one
    reserved), requests finish, one replica dies and one joins.  Returns
    every observable of the book as comparable tuples."""
    est = core.BatchLatencyEstimator(a_p=1e-8, b_p=1e-8, c_p=1e-4,
                                     a_d=1e-8, b_d=1e-3, t_c=1e-2)
    router = (core.GoRouting(est, core.RouterConfig(pd_mode=pd_mode))
              if router_name == "gorouting"
              else core.ROUTERS[router_name](est))
    book = book_cls(router, est)
    roles = (["prefill", "prefill", "decode", "decode", "coloc"]
             if pd_mode == "disagg" else ["coloc"] * 4)
    for iid, role in enumerate(roles):
        book.add_instance(iid, 60, 60, role=role)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 1000, 48)
    live: dict = {}          # rid -> (iid, request)
    log, now, next_iid = [], 0.0, len(roles)

    def snapshot():
        return (tuple(sorted(
            (i, st.role, tuple(sorted(st.pre_queue)), st.n_d, st.b_f,
             st.prefill_len_total, round(st.ts, 12), round(st.speed, 12),
             st.alive, st.reserved_blocks)
            for i, st in book.states.items())),
            tuple(sorted(book.reservations.items())),
            book.reservation_hits, book.reservation_misses,
            book.reserved_blocks_total, book.adopted_blocks_total,
            book.handoffs, book.handoff_blocks, book.handoff_bytes)

    for step in range(60):
        now += float(rng.uniform(0.001, 0.05))
        for _ in range(int(rng.integers(0, 3))):
            plen = int(rng.integers(20, 300))
            prompt = rng.integers(1, 1000, plen)
            if rng.random() < 0.5 and plen > 64:
                prompt[:48] = prefix
            prio = int(rng.integers(1, 4))
            req = core.Request(prompt_len=plen,
                               output_len=int(rng.integers(1, 20)),
                               arrival=now,
                               slo=core.SLO(0.2 * prio, 0.05), priority=prio,
                               weight=float(4 - prio))
            book.log_request(req, prompt)
            iid = book.route(req, now, prompt_tokens=prompt)
            log.append(("route", step, iid, book.decode_target(req.rid)))
            if iid is not None:
                live[req.rid] = (iid, req)
        for rid in sorted(live):
            iid, req = live[rid]
            if iid not in book.states:
                continue
            u = rng.random()
            if u < 0.2:
                book.observe_step(iid, free_blocks=int(rng.integers(0, 60)),
                                  est_time=float(rng.uniform(1e-3, 0.05)),
                                  latency=float(rng.uniform(1e-3, 0.05)))
            elif u < 0.45 and book.states[iid].role == "prefill":
                book.on_first_token(iid, rid, now)
                book.on_handoff_sent(iid, rid, now)
                d_iid = book.decode_target(rid)
                if d_iid is None or rng.random() < 0.2:
                    d_pool = [st for st in book.states.values()
                              if st.role == "decode"]
                    d_iid = core.gorouting.pick_decode_target(
                        d_pool, req, book.block_size)
                if d_iid is None:
                    book.release_reservation(rid)
                    del live[rid]
                    continue
                nb = core.gorouting.decode_need_blocks(req, 16)
                book.on_handoff_delivered(rid, d_iid, nb, nb * 4096, now)
                live[rid] = (d_iid, req)
            elif u < 0.6:
                book.on_first_token(iid, rid, now)
            elif u < 0.75:
                book.on_finished(iid, rid)
                del live[rid]
            else:
                book.heartbeat(iid, int(rng.integers(0, 60)))
        if step == 30:
            victim = 2 if pd_mode == "disagg" else 0
            book.drop_instance(victim)
            log.append(("drop", victim))
        if step == 40:
            book.add_instance(next_iid, 60, 60, role=roles[2])
            next_iid += 1
        log.append(snapshot())
    return log


@pytest.mark.parametrize("router,pd_mode", [
    ("gorouting", "coloc"), ("gorouting", "disagg"),
    ("min_load", "disagg"), ("round_robin", "disagg")])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_book_routes_identically(router, pd_mode, seed):
    want = route_log(jcore, JRouterBook, router, pd_mode, seed)
    got = route_log(tcore, TRouterBook, router, pd_mode, seed)
    assert got == want
    routes = [e for e in want if e[0] == "route"]
    assert len({e[2] for e in routes}) > 1, "every request on one replica"
    if pd_mode == "disagg":
        assert want[-1][6] > 0, "no handoff was delivered"
        assert any(e[3] is not None for e in routes), "nothing reserved"


def test_tdg_and_estimator_agree():
    r_j = jcore.Request(prompt_len=10, output_len=4, arrival=0.0,
                        slo=jcore.SLO(0.5, 0.1), weight=2.0)
    r_t = tcore.Request(prompt_len=10, output_len=4, arrival=0.0,
                        slo=tcore.SLO(0.5, 0.1), weight=2.0)
    for t in (0.3, 0.55, 0.7, 0.95):
        r_j.emit_token(t)
        r_t.emit_token(t)
    assert tcore.tdg_ratio([r_t], 4.0) == jcore.tdg_ratio([r_j], 4.0)
    batches = [[(64, 0, True)], [(1, 100, False)] * 4, [(32, 64, True)],
               [(1, 300, False)] * 8 + [(128, 0, True)]]
    lats = [0.011, 0.004, 0.009, 0.02]
    ej = jcore.BatchLatencyEstimator.fit(batches, lats)
    et = tcore.BatchLatencyEstimator.fit(batches, lats)
    assert dataclasses.asdict(et) == dataclasses.asdict(ej)
