"""The port's span recorder (``repro_torch.obs``) and the spans the
serving path records with it: the ring's bound, threads, the off switch,
nesting and the Chrome export; a tiny CPU engine under ``EngineDriver``
and ``ServiceFrontend`` whose spans order each request's life and match
stamps taken outside the same calls; each reason an empty scheduling
round gives; plans unchanged by the recorder, which costs nothing per
request while off; and the window-safe counters."""
import asyncio
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.core import (SLO, BlockManager, EngineConfig, GoRouting,
                              Request, RouterConfig, SlideBatching,
                              make_policy)
from repro_torch.core.batching import SchedView
from repro_torch.core.blocks import CopyPlan
from repro_torch.core.estimator import BatchLatencyEstimator
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, TransferWorker
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.frontend import FrontendConfig, ServiceFrontend

CFG = get_smoke("qwen1_5_0_5b")
PARAMS = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
LOOSE = SLO(3600.0, 3600.0)
EST = dict(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3, t_c=1e-2)


def make_engine(num_blocks=160, **kw):
    return Engine(CFG, PARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  make_policy("slidebatching"), num_blocks=num_blocks,
                  block_size=16, max_ctx=256, device="cpu", **kw)


def new_request(plen, olen, slo=LOOSE, arrival=0.0, prio=2):
    return Request(prompt_len=plen, output_len=olen, arrival=arrival,
                   slo=slo, priority=prio)


def request_spans(streams):
    """The ``request.*`` spans of these streams' requests."""
    rids = {s.request.rid for s in streams}
    t0 = min(s.submitted for s in streams)
    return [s for s in obs.recorder().spans() if s.rid in rids
            and s.t0 >= t0 and s.name.startswith(obs.REQUEST)]


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_the_ring_stays_bounded():
    rec = obs.Recorder(capacity=64)
    for i in range(1000):
        with rec.span("x", i=i):
            pass
    held = rec.spans()
    assert len(held) == 64
    assert [s.attrs["i"] for s in held] == list(range(936, 1000))
    assert obs.recorder().capacity == obs.CAPACITY


def test_off_records_nothing():
    rec = obs.Recorder()
    rec.enabled = False
    with rec.span("a") as a:
        a.set(rows=3)
        rec.record("request.x", 0.0, 1.0, rid=1)
        assert rec.current() == 0
    assert rec.spans() == []
    assert rec.span("b") is rec.span("c")        # one shared no-op


def test_set_enabled_switches_the_process_recorder():
    try:
        obs.set_enabled(False)
        with obs.span("test.off"):
            obs.record("test.off", 0.0, 1.0)
    finally:
        obs.set_enabled(True)
    with obs.span("test.on") as on:
        pass
    names = {s.name for s in obs.recorder().spans()}
    assert "test.off" not in names and "test.on" in names and on.sid > 0


def test_spans_nest_with_the_right_parent():
    rec = obs.Recorder()
    with rec.span("outer", rid=7) as o:
        with rec.span("inner", kind="decode") as i:
            rec.record("request.wait", 0.5, 0.75, rid=7, hit=3)
            i.set(rows=2)
        with rec.span("sibling"):
            pass
    got = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["request.wait", "inner",
                                             "sibling", "outer"]
    assert got["outer"].parent == 0 and got["outer"].rid == 7
    assert got["inner"].parent == got["sibling"].parent == o.sid
    assert got["request.wait"].parent == i.sid
    assert got["inner"].attrs == {"kind": "decode", "rows": 2}
    assert got["sibling"].attrs is None
    assert got["outer"].t0 <= got["inner"].t0 <= got["inner"].t1 \
        <= got["sibling"].t0 <= got["sibling"].t1 <= got["outer"].t1
    assert rec.record("x", 0.0, 1.0, parent=99) is None
    assert rec.spans()[-1].parent == 99


def test_threads_record_safely():
    rec = obs.Recorder(capacity=1 << 16)
    n_threads, n_spans = 16, 300
    errors = []
    ready = threading.Barrier(n_threads)    # all alive at once

    def work():
        try:
            ready.wait(timeout=60)
            for k in range(n_spans):
                with rec.span("outer") as o:
                    with rec.span("inner"):
                        pass
                    rec.record("point", 0.0, 1.0, k=k)
                    assert rec.current() == o.sid
        except Exception as exc:     # surfaced by the assertion below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = rec.spans()
    assert len(spans) == 3 * n_threads * n_spans
    assert len({s.sid for s in spans}) == len(spans)
    by_sid = {s.sid: s for s in spans}
    for s in spans:
        if s.name == "outer":
            assert s.parent == 0
        else:                        # its parent is its own thread's outer
            parent = by_sid[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
            assert parent.t0 <= s.t0 or s.name == "point"
    assert len({s.thread for s in spans}) == n_threads


def test_the_transfer_worker_records_its_copies_on_its_thread():
    w = TransferWorker(device="cpu")
    blk = np.zeros((2, 2, 4, 2, 8), np.float32)
    try:
        with obs.span("test.enqueue") as sp:
            w.offload(3, 0, [0, 1], torch.zeros((2,) + blk.shape))
            assert w.prefetch(4, 0, [blk, blk, blk])
        assert w.flush()
    finally:
        w.stop()
    lanes = {s.name: s for s in obs.recorder().spans()
             if s.name.startswith("lanes.") and s.parent == sp.sid}
    d2h, h2d = lanes["lanes.d2h"], lanes["lanes.h2d"]
    assert (d2h.rid, d2h.attrs) == (3, {"quantized": 0})
    assert (h2d.rid, h2d.attrs) == (4, {"quantized": 0})
    assert d2h.thread == h2d.thread != threading.get_ident()
    assert obs.recorder().thread_name(d2h.thread) == "kv-transfer"
    done = {d.kind: d.seconds for d in w.drain()}
    assert d2h.t1 - d2h.t0 == pytest.approx(done["d2h"])


def test_export_chrome_writes_a_valid_trace(tmp_path):
    rec = obs.Recorder()
    with rec.span("engine.step", rows=2):
        rec.record("request.queued", 1.0, 1.5, rid=9, hit=16)
    path = tmp_path / "trace.json"
    rec.export_chrome(path)
    doc = json.loads(Path(path).read_text())
    ev = doc["traceEvents"]
    assert {e["ph"] for e in ev} == {"M", "X", "b", "e"}
    step = next(e for e in ev if e["ph"] == "X")
    assert step["name"] == "engine.step" and step["args"]["rows"] == 2
    assert step["dur"] >= 0 and step["tid"] == threading.get_ident()
    begin = next(e for e in ev if e["ph"] == "b")
    end = next(e for e in ev if e["ph"] == "e")
    assert (begin["id"], begin["ts"], end["ts"]) == (9, 1e6, 1.5e6)
    assert begin["args"]["hit"] == 16
    names = [e for e in ev if e["ph"] == "M"]
    assert names[0]["args"]["name"] == threading.current_thread().name


# --------------------------------------------------------------------------
# the serving path's spans
# --------------------------------------------------------------------------

class Stamps:
    """``time.monotonic()`` around the calls that the program's spans
    cover, taken from outside: ``Engine.step`` (whether it found requests
    queued, and whether it then formed no batch while work was held), the
    policy's ``form_batch`` (whether requests were queued) and the two
    model calls (kind, rows)."""

    def __init__(self, eng):
        self.steps, self.forms, self.model = [], [], []
        step, form = eng.step, eng.policy.form_batch

        def stamped_step():
            t0, queued = time.monotonic(), bool(eng.queue)
            res = step()
            self.steps.append((t0, time.monotonic(), queued,
                               res is None and eng.has_work()))
            return res

        def stamped_form(view):
            t0 = time.monotonic()
            plan = form(view)
            self.forms.append((t0, time.monotonic(), bool(view.queue)))
            return plan

        def stamped(fn, store, kind):
            def call(*a):
                t0 = time.monotonic()
                try:
                    return fn(*a)
                finally:
                    store.append((t0, time.monotonic(), kind, len(a[0])))
            return call
        eng.step = stamped_step
        eng.policy.form_batch = stamped_form
        eng._run_prefill_packed = stamped(eng._run_prefill_packed,
                                          self.model, "prefill")
        eng._run_decode = stamped(eng._run_decode, self.model, "decode")


def serve(n=6, olen=4, stamps=False):
    """``n`` requests (half sharing a 32-token prefix) through one tiny CPU
    engine under its driver and a front end; returns (streams, engine,
    its outside ``Stamps`` or None, the spans the driver's thread
    recorded)."""
    t_start = time.monotonic()
    rng = np.random.default_rng(1)
    shared = rng.integers(1, CFG.vocab, 32).astype(np.int32)
    est = BatchLatencyEstimator(**EST)
    fe = ServiceFrontend(GoRouting(est, RouterConfig(pd_mode="coloc")), est,
                         FrontendConfig())
    eng = make_engine()
    fe.add_instance(eng)
    outside = Stamps(eng) if stamps else None

    async def run():
        await fe.start()
        streams = []
        for k in range(n):
            tail = rng.integers(1, CFG.vocab, 8 + 3 * k).astype(np.int32)
            prompt = np.concatenate([shared, tail]) if k % 2 else tail
            streams.append(await fe.submit(
                new_request(len(prompt), olen), prompt))
            await asyncio.sleep(0.01)
        await asyncio.gather(*[s.collect() for s in streams])
        driver = fe.drivers[0]._thread.ident
        await fe.stop()
        return streams, driver

    try:
        streams, driver = asyncio.run(run())
    finally:
        eng.kill()
    spans = [s for s in obs.recorder().spans()
             if s.thread == driver and s.t0 >= t_start]
    return streams, eng, outside, spans


def test_each_request_goes_submit_add_schedule_first_last_in_order():
    streams, eng, _, on_driver = serve()
    driver = on_driver[0].thread
    spans = request_spans(streams)
    by = {(s.name, s.rid): s for s in spans}
    assert len(by) == len(spans) == 4 * len(streams)
    for st in streams:
        rid = st.request.rid
        inbox, queued = by["request.inbox", rid], by["request.queued", rid]
        prefill, decode = by["request.prefill", rid], \
            by["request.decode", rid]
        assert st.submitted <= inbox.t0 <= inbox.t1 <= queued.t0 \
            <= queued.t1 == prefill.t0 <= prefill.t1 == decode.t0 \
            <= decode.t1 <= st.recv_times[-1]
        assert prefill.t1 <= st.recv_times[0]
        assert {inbox.thread, queued.thread, decode.thread} == {driver}
    hits = [by["request.queued", s.request.rid].attrs["hit"]
            for s in streams]
    assert sum(hits) == eng.stats.cache_hit_tokens > 0


def test_engine_spans_nest_under_the_step_on_the_driver_thread():
    _, _, _, spans = serve()
    by_sid = {s.sid: s for s in spans}
    names = {s.name for s in spans}
    assert {"engine.step", "engine.transfers", "engine.reload",
            "engine.release", "engine.offloads", "engine.prefetch",
            "sched.form_batch", "model_exec.prep", "model_exec.upload",
            "model_exec.launch", "model_exec.fetch", "engine.emit",
            "driver.inbox", "driver.events"} <= names
    for s in spans:
        if s.name.startswith(("engine.", "sched.", "model_exec.")) \
                and s.name != "engine.step":
            assert by_sid[s.parent].name == "engine.step"
            assert by_sid[s.parent].t0 <= s.t0 <= s.t1 \
                <= by_sid[s.parent].t1
        elif s.name.startswith("driver.") or s.name == "engine.step":
            assert s.parent == 0
    # the driver idled between submissions: its parks there, and the
    # steps that found nothing queued, are not recorded
    assert "driver.park" not in names
    launches = [s for s in spans if s.name == "model_exec.launch"]
    assert {s.attrs["kind"] for s in launches} == {"prefill", "decode"}
    assert all(s.attrs["rows"] >= 1 and s.attrs["tokens"] >= 1
               for s in launches)


def test_program_spans_match_stamps_outside_the_same_calls():
    """The program's spans of ``Engine.step``, the policy's
    ``form_batch`` and the two model calls against stamps taken outside
    the same calls: one for one over the steps that found requests
    queued (a step with none records nothing), the outside interval
    around the step span and the model call's launch span, and inside
    the ``sched.form_batch`` span (stamped at the engine's call)."""
    _, _, outside, spans = serve(stamps=True)
    steps = [s for s in spans if s.name == "engine.step"]
    forms = [s for s in spans if s.name == "sched.form_batch"]
    held = [x for x in outside.steps if x[2]]
    assert len(steps) == len(held) > 0 and len(held) < len(outside.steps)
    assert len(forms) == sum(q for _, _, q in outside.forms)
    for s, (a, b, _, _) in zip(steps, held):
        assert a <= s.t0 <= s.t1 <= b
    for s, (a, b, _) in zip(forms, [x for x in outside.forms if x[2]]):
        assert s.t0 <= a <= b <= s.t1
    empty = [s for s in forms if s.attrs["entries"] == 0
             and s.attrs["queued"] > 0]
    assert len(empty) == sum(e for _, _, _, e in outside.steps)
    launches = [s for s in spans if s.name == "model_exec.launch"]
    assert [(s.attrs["kind"], s.attrs["rows"]) for s in launches] == \
        [(k, rows) for _, _, k, rows in outside.model]
    for s, (a, b, _, _) in zip(launches, outside.model):
        assert a <= s.t0 <= s.t1 <= b


def test_an_idle_driver_records_nothing_and_a_held_one_its_parks():
    t_start = time.monotonic()
    eng = make_engine(est=BatchLatencyEstimator(**dict(EST, t_c=5.0)))
    driver = engine_mod.EngineDriver(0, eng, lambda ev: None)
    driver.start()
    try:
        time.sleep(0.2)                   # nothing to do: ~100 parks
        t_held = time.monotonic()
        # t_c far above the budget: rounds come back empty, work held
        driver.submit(new_request(40, 4, slo=SLO(0.05, 0.05)),
                      np.arange(1, 41, dtype=np.int32))
        time.sleep(0.2)
    finally:
        driver.stop()
        eng.kill()
    mine = [s for s in obs.recorder().spans()
            if s.thread == driver._thread.ident and s.t1 >= t_start]
    assert mine and min(s.t0 for s in mine) >= t_held
    parks = [s for s in mine if s.name == "driver.park"]
    forms = [s for s in mine if s.name == "sched.form_batch"]
    assert len(parks) >= 10 and len(forms) >= len(parks)
    assert forms[0].attrs["reason"] == "budget"


# --------------------------------------------------------------------------
# why a round admitted nothing
# --------------------------------------------------------------------------

def plan_with(reqs, bm, est=None, eta=1.0, now=0.0):
    est = est or BatchLatencyEstimator(**EST)
    cfg = EngineConfig(eta=eta, w_p=4.0, tau=1e9)
    return SlideBatching().form_batch(SchedView(list(reqs), bm, est, cfg,
                                                now))


def test_budget_reason_when_t_c_reaches_the_budget():
    r = new_request(40, 4, slo=SLO(0.05, 0.05))
    est = BatchLatencyEstimator(**dict(EST, t_c=0.5))
    plan = plan_with([r], BlockManager(64, 16, 5e-4), est=est, eta=0.01)
    assert not plan.entries and plan.idle_reason == "budget"
    assert plan.t_budget < est.t_c


def test_copy_reason_when_the_head_reload_is_refused(monkeypatch):
    bm = BlockManager(64, 16, 5e-4, async_offload=False)
    head, other = new_request(40, 4, arrival=-1.0), new_request(40, 4)
    bm.grow(head, 32, 0.0)
    bm.evict(head, 0.0)
    assert bm.state(head).host_tokens > 0
    # SlideBatching only ever asks for a reload the request can partially
    # take (its chunk cap never passes the tokens it has left), so the
    # refusal is planted
    monkeypatch.setattr(bm, "plan_reload",
                        lambda *a, **k: CopyPlan(admitted=False))
    bm.used_blocks = bm.num_device_blocks       # the other finds no block
    plan = plan_with([head, other], bm)
    assert not plan.entries and plan.idle_reason == "copy"


def test_blocks_reason_when_no_block_frees_up():
    bm = BlockManager(2, 16, 5e-4)
    plan = plan_with([new_request(100, 4)], bm)
    assert not plan.entries and plan.idle_reason == "blocks"


def test_none_ready_reason_when_no_request_has_work():
    bm = BlockManager(64, 16, 5e-4)
    r = new_request(40, 4)
    bm.grow(r, 40, 0.0)          # prompt resident, first token not out
    plan = plan_with([r], bm)
    assert not plan.entries and plan.idle_reason == "none_ready"


def test_no_reason_when_a_batch_forms_or_nothing_is_queued():
    bm = BlockManager(64, 16, 5e-4)
    assert plan_with([new_request(40, 4)], bm).idle_reason == ""
    assert plan_with([], bm).idle_reason == ""


def test_the_engine_records_the_reason_on_its_form_batch_span():
    eng = make_engine(est=BatchLatencyEstimator(**dict(EST, t_c=5.0)))
    try:
        r = new_request(40, 4, slo=SLO(0.05, 0.05))
        eng.add_request(r, np.arange(1, 41, dtype=np.int32))
        assert eng.step() is None
    finally:
        eng.kill()
    form = [s for s in obs.recorder().spans("sched.form_batch")
            if s.thread == threading.get_ident()][-1]
    assert form.attrs["reason"] == "budget"
    assert (form.attrs["entries"], form.attrs["queued"]) == (0, 1)
    assert form.attrs["t_c"] == 5.0 > form.attrs["t_budget"]


# --------------------------------------------------------------------------
# the recorder changes no decision
# --------------------------------------------------------------------------

class FakeClock:
    """``time`` for the engine module: it stands still but while the
    model runs, so the engine's clock and its estimator's refits repeat
    however often the engine reads it."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def replay_plans(monkeypatch, on: bool) -> list:
    clock = FakeClock()
    monkeypatch.setattr(engine_mod, "time", clock)
    rng = np.random.default_rng(11)
    eng = Engine(CFG, PARAMS, EngineConfig(eta=0.002, w_p=4.0, tau=1e9),
                 make_policy("slidebatching"), num_blocks=24, block_size=16,
                 max_ctx=256, overlap_transfers=False, device="cpu",
                 est=BatchLatencyEstimator(**EST))
    eng.refit_every = 4
    for name in ("_run_prefill_packed", "_run_decode"):
        def timed(entries, emitted, call=getattr(eng, name)):
            # a model call takes 2 ms and 10 us a token
            clock.t += 2e-3 + 1e-5 * sum(e.n_tokens for e in entries)
            return call(entries, emitted)
        setattr(eng, name, timed)
    plans = []
    form = eng.policy.form_batch

    def logged(view):
        plan = form(view)
        plans.append((tuple((e.req.rid, e.n_tokens, e.l_kv, e.is_prefill)
                            for e in plan.entries),
                      tuple(r.rid for r in plan.evictions), plan.est_time,
                      plan.t_budget, plan.copy_blocks, plan.idle_reason))
        return plan
    eng.policy.form_batch = logged
    arrivals = [(0.01 * k, int(rng.integers(16, 60)),
                 int(rng.integers(4, 24)), 1 + k % 3) for k in range(16)]
    # one prompt longer than the pool holds: rounds with no block for it
    arrivals.insert(5, (0.05, 400, 4, 3))
    obs.set_enabled(on)
    try:
        base = None
        for step in range(400):
            while arrivals and arrivals[0][0] <= eng.now:
                _, plen, olen, prio = arrivals.pop(0)
                r = new_request(plen, olen, slo=SLO(0.05 * prio, 0.01 * prio),
                                arrival=eng.now, prio=prio)
                if base is None:
                    base = r.rid
                eng.add_request(r, rng.integers(1, CFG.vocab, plen)
                                .astype(np.int32))
            if eng.step() is None:
                eng.now += 1e-3
            if not arrivals and not eng.has_work():
                break
    finally:
        obs.set_enabled(True)
        eng.kill()
    # rids differ between the two replays: count them from the first
    return [(tuple((e[0] - base,) + e[1:] for e in p[0]),
             tuple(x - base for x in p[1])) + p[2:] for p in plans]


def sim_plans(on: bool) -> list:
    """A ShareGPT replay through the simulator's SlideBatching engine."""
    from repro_torch import sim
    from repro_torch.sim.workloads import sharegpt
    ex = sim.AnalyticalExecutor(sim.QWEN2_7B, sim.InstanceHardware(chips=4))
    est, _ = ex.fit_estimator(n=200)
    reqs = sharegpt(rate=20, duration=5, seed=2)
    base = min(r.rid for r in reqs)
    eng = sim.EngineSim(0, make_policy("slidebatching"), ex, est,
                        EngineConfig(w_p=4.0))
    plans = []
    form = eng.policy.form_batch

    def logged(view):
        plan = form(view)
        plans.append((tuple((e.req.rid - base, e.n_tokens, e.l_kv)
                            for e in plan.entries), plan.est_time,
                      plan.idle_reason))
        return plan
    eng.policy.form_batch = logged
    obs.set_enabled(on)
    try:
        pending, now, i = sorted(reqs, key=lambda r: r.arrival), 0.0, 0
        while i < len(pending) or eng.has_work():
            while i < len(pending) and pending[i].arrival <= now:
                eng.add_request(pending[i], now)
                i += 1
            res = eng.step(now)
            if res is not None:
                now = res.end
            elif i < len(pending):
                now = pending[i].arrival
            else:
                break
    finally:
        obs.set_enabled(True)
    return plans


@pytest.mark.parametrize("replay", ["engine", "simulator"])
def test_plans_are_the_same_with_the_recorder_on_and_off(monkeypatch,
                                                         replay):
    if replay == "engine":
        on = replay_plans(monkeypatch, True)
        off = replay_plans(monkeypatch, False)
        assert any(p[-1] for p in on)               # empty rounds too
    else:
        on, off = sim_plans(True), sim_plans(False)
    assert on == off and len(on) > 20


def test_while_off_the_serving_path_keeps_no_stamps():
    rng = np.random.default_rng(5)
    t_start = time.monotonic()
    eng = make_engine()
    driver = engine_mod.EngineDriver(0, eng, lambda ev: None)
    r = new_request(40, 3)
    prompt = rng.integers(1, CFG.vocab, 40).astype(np.int32)
    obs.set_enabled(False)
    try:
        driver.submit(r, prompt)
        item = driver.inbox.get_nowait()
        assert item[1] is r and item[-1] is None
        driver.inbox.put(item)
        driver._drain_inbox()
        assert eng._t_req == {} and r.rid in eng.outputs
        eng.run_until_drained(max_iters=50)
        assert len(eng.outputs[r.rid]) == 3 and eng._t_req == {}
    finally:
        obs.set_enabled(True)
        eng.kill()
    assert not [s for s in obs.recorder().spans()
                if s.t1 >= t_start or s.rid == r.rid]


# --------------------------------------------------------------------------
# window-safe counters
# --------------------------------------------------------------------------

def test_busy_s_sums_every_step_past_any_window(monkeypatch):
    eng = make_engine()
    lats = []
    step = Engine.step

    def logged(self):
        res = step(self)
        if res is not None:
            lats.append(res["latency"])
        return res
    monkeypatch.setattr(Engine, "step", logged)
    rng = np.random.default_rng(2)
    try:
        eng.add_request(new_request(20, 600),
                        rng.integers(1, CFG.vocab, 20).astype(np.int32))
        eng.run_until_drained(max_iters=1000)
    finally:
        eng.kill()
    assert len(lats) > 512 and eng.stats.iterations == len(lats)
    assert eng.stats.busy_s == pytest.approx(sum(lats), rel=1e-12)


def test_lane_counters_count_every_copy_in_each_direction():
    rng = np.random.default_rng(4)
    t_start = time.monotonic()
    eng = make_engine(num_blocks=24)
    try:
        for _ in range(3):
            eng.add_request(new_request(48, 3, prio=3),
                            rng.integers(1, CFG.vocab, 48).astype(np.int32))
        eng.run_until_drained(max_iters=400)
        assert eng.flush_transfers() and not eng.has_work()
        st = eng.stats
        # every mirror copied counts, also those landing after their
        # request finished (offload_blocks counts the live ones)
        assert st.d2h_copy_blocks > 0 and st.d2h_copy_s > 0
        assert st.d2h_copy_blocks >= st.offload_blocks
        d2h = [s for s in obs.recorder().spans("lanes.d2h")
               if s.thread == eng.worker._thread.ident and s.t0 > t_start]
        assert sum(s.t1 - s.t0 for s in d2h) == \
            pytest.approx(st.d2h_copy_s)
        # a staged reload: the H2D lane's counters
        assert eng.worker.prefetch(-7, 0, [np.zeros(4, np.float32)])
        assert eng.flush_transfers()
        assert (st.h2d_copy_blocks, st.h2d_copy_s > 0) == (1, True)
    finally:
        eng.kill()
