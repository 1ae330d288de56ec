"""The port's copy of the scheduling core plans exactly what the JAX
package's core plans: the same scheduling scenarios, driven through
``repro.core`` and ``repro_torch.core``, give identical BatchPlans
(entries, chunk sizes, evictions, copy budgets) step by step."""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import make_policy


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
