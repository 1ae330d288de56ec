"""The readers of the program's own spans (``bench/spans.py`` and the four
metrics that use it) on synthetic runs, the slice's idle time put down to
the innermost span of the engine's thread, each request's time to first
token split at its spans' edges, a smoke cell that reports the three
host-clock ones and whose program spans match the benchmark's wrappers,
and a checkout whose program has no recorder."""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import pytest
import torch

from bench import harness, spans, yardstick
from bench.tests import smoke
from bench.trace import MARKER, DeviceTrace
from repro_torch.obs import Span

NEW = ("driver.inbox_wait_p75_ms", "engine.queue_wait_p75_ms",
       "sched.empty_round_share", "model_exec.launch_idle_share")


def read(name, run):
    return harness.load_reader(smoke.ROOT, name)(run)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in place of the program's process-wide one."""
    from repro_torch import obs
    fresh = obs.Recorder()
    monkeypatch.setattr(obs, "recorder", lambda: fresh)
    return fresh


def rec_of(rid, error=None):
    return SimpleNamespace(req=SimpleNamespace(rid=rid), error=error)


def make_run(measured=(), window=(10.0, 20.0), prof=None, inst=None):
    return SimpleNamespace(
        measured=list(measured), window=window, seconds=10.0,
        cell=SimpleNamespace(mix={"drain_limit_s": 5.0, "ramp_s": 1.0}),
        prof=prof, inst=inst)


# --------------------------------------------------------------------------
# request waits and empty rounds
# --------------------------------------------------------------------------

def test_request_waits_are_the_p75_over_the_measured_requests(rec):
    for rid in range(8):                         # 1..8 ms
        rec.record("request.inbox", 12.0, 12.0 + (rid + 1) * 1e-3,
                   rid=rid)
    rec.record("request.inbox", 12.0, 14.0, rid=99)    # not measured
    rec.record("request.queued", 12.0, 12.5, rid=0)
    run = make_run([rec_of(r) for r in range(8)]
                   + [rec_of(50, error="refused: quota")])
    want = yardstick.percentile([float(r + 1) for r in range(8)], 75.0)
    assert read("driver.inbox_wait_p75_ms", run) == pytest.approx(want)


def test_a_request_never_scheduled_ranks_as_failed(rec):
    for rid in range(4):
        rec.record("request.queued", 12.0, 12.001, rid=rid)
    run = make_run([rec_of(r) for r in range(5)])      # rid 4: no span
    assert read("engine.queue_wait_p75_ms", run) == pytest.approx(1.0)
    run = make_run([rec_of(r) for r in range(4)] + [rec_of(4), rec_of(5)])
    # two of six without a span: the 75th percentile lands on them
    assert read("engine.queue_wait_p75_ms", run) == 1e3 * 16.0


def test_empty_round_share_counts_rounds_with_work_held(rec):
    def form(t, queued, reason=None):
        rec.record("sched.form_batch", t, t + 1e-4, entries=0 if reason
                   else 1 if queued else 0, queued=queued,
                   **({"reason": reason} if reason else {}))
    form(11.0, 0)                       # nothing queued: not counted
    for k in range(6):
        form(12.0 + k, 3)               # six batches formed
    form(18.0, 3, "budget")
    form(18.5, 2, "budget")
    form(19.0, 2, "blocks")
    form(25.0, 2, "copy")               # after the window
    run = make_run()
    assert read("sched.empty_round_share", run) == pytest.approx(100 * 3 / 9)
    held, reasons = spans.empty_rounds(run)
    assert held == 9 and reasons == {"budget": 2, "blocks": 1}
    assert read("sched.empty_round_share", make_run(window=(30.0, 40.0))) \
        is None                         # no round at all: nothing to read
    form(31.0, 0)
    assert read("sched.empty_round_share", make_run(window=(30.0, 40.0))) \
        == 0.0


def served(rid, due, out_times):
    return SimpleNamespace(req=SimpleNamespace(rid=rid), error=None,
                           failed=False, arrival=due,
                           out_times=list(out_times))


def test_ttft_split_cuts_each_request_at_its_spans_edges(rec):
    for rid, k in ((1, 1.0), (2, 2.0)):
        due = 12.0 * k
        rec.record("request.inbox", due + 0.001 * k, due + 0.010 * k,
                   rid=rid)
        rec.record("request.queued", due + 0.011 * k, due + 0.020 * k,
                   rid=rid)
        rec.record("request.prefill", due + 0.020 * k, due + 0.100 * k,
                   rid=rid)
        rec.record("request.decode", due + 0.100 * k, due + 0.400 * k,
                   rid=rid)
    rec.record("request.inbox", 30.0, 30.1, rid=3)     # no other span
    run = make_run([served(1, 12.0, [12.101, 12.2, 12.3, 12.401]),
                    served(2, 24.0, [24.202, 24.5, 24.802]),
                    served(3, 30.0, [30.5])])
    got = spans.ttft_split(run)
    assert got["n"] == 2
    # request 1: 1 + 10 + 9 + 80 + 1 = 101 ms; request 2 twice each part
    want = {"frontend": (1, 2), "inbox": (10, 20), "queued": (9, 18),
            "prefill": (80, 160), "to_client": (1, 2), "ttft": (101, 202),
            "decode_per_token": (100, 300)}
    for k, (lo, hi) in want.items():
        p50, p75 = got[k]
        assert p50 == pytest.approx((lo + hi) / 2, abs=1e-6), k
        assert p75 == pytest.approx(lo + 0.75 * (hi - lo), abs=1e-6), k
    assert spans.ttft_split(make_run([served(3, 30.0, [30.5])])) is None


def test_a_recorder_that_was_off_reads_nothing(rec):
    rec.enabled = False
    rec.record("request.inbox", 12.0, 12.1, rid=1)
    run = make_run([rec_of(1)])
    assert [read(n, run) for n in NEW] == [None] * 4


# --------------------------------------------------------------------------
# the slice's idle time by span
# --------------------------------------------------------------------------

class Ev:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, a_us, b_us, cuda=True):
        self._n, self._a, self._b, self._cuda = name, a_us, b_us, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._a * 1e3)

    def duration_ns(self):
        return int((self._b - self._a) * 1e3)

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self._cuda else d.CPU


def traced(events, markers=(100.0, 101.0), window=(95.0, 101.0)):
    """A run whose profiled slice holds ``events`` (device clock = host
    clock + 500 us)."""
    tuples = [(e.name(), e.start_ns() / 1e3,
               (e.start_ns() + e.duration_ns()) / 1e3) for e in events
              if e._cuda]
    inst = SimpleNamespace(
        slice=markers, markers=list(markers),
        _prof=SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))),
        steps=[], forms=[], model=[])
    prof = DeviceTrace.read(tuples, list(markers), inst)
    return make_run(window=window, prof=prof, inst=inst)


OFF = 500.0


def us(t):
    """Host seconds to device microseconds."""
    return t * 1e6 + OFF


SLICE = [Ev(MARKER, us(100.0), us(100.0) + 1),
         Ev("gemm", us(100.0), us(100.3)),            # busy 0.0-0.3
         Ev("gemm", us(100.5), us(100.6)),            # busy 0.5-0.6
         Ev("cudaLaunchKernel", us(100.3), us(100.5), cuda=False),
         Ev("early", us(90.0), us(90.1)),             # long before
         Ev(MARKER, us(101.0), us(101.0) + 1)]


def test_idle_gaps_are_the_trace_s_idle_time():
    run = traced(SLICE)
    gaps = spans.device_idle(run)
    assert gaps == pytest.approx([(100.3, 100.5), (100.6, 101.0)])
    assert sum(b - a for a, b in gaps) == pytest.approx(
        run.prof.wall_s - run.prof.busy_s)
    assert spans.device_idle(run) is gaps        # read once, then cached


def test_idle_time_goes_to_the_innermost_span_of_the_engine_thread(rec):
    engine, other = 1, 2

    def put(name, a, b, thread=engine, rid=None):
        rec._ring.append(Span(name, a, b, len(rec._ring) + 1, 0, thread,
                              rid, None))
    put("engine.step", 100.2, 100.45)
    put("model_exec.launch", 100.25, 100.35)
    put("model_exec.fetch", 100.35, 100.44)
    put("driver.park", 100.6, 100.7)
    put("engine.step", 100.7, 100.9)
    put("model_exec.launch", 100.75, 100.85)
    put("lanes.d2h", 100.3, 100.9, thread=other)
    put("request.queued", 100.0, 101.0, rid=3)
    run = traced(SLICE)
    by = spans.idle_by_span(run)
    # idle 100.3-100.5: launch 0.05, fetch 0.09, step 0.01, none 0.05;
    # idle 100.6-101.0: park 0.1, step 0.1, launch 0.1, none 0.1
    assert by == pytest.approx({"model_exec.launch": 0.15,
                                "model_exec.fetch": 0.09,
                                "engine.step": 0.11, "driver.park": 0.1,
                                "none": 0.15})
    assert sum(by.values()) == pytest.approx(run.prof.wall_s
                                             - run.prof.busy_s)
    assert read("model_exec.launch_idle_share", run) == pytest.approx(15.0)


def test_innermost_pieces_follow_the_nesting():
    got = spans.innermost([(0, 10, "P"), (2, 5, "C"), (6, 8, "D"),
                           (6, 7, "E"), (12, 13, "Q")])
    assert got == [(0, 2, "P"), (2, 5, "C"), (5, 6, "P"), (6, 7, "E"),
                   (7, 8, "D"), (8, 10, "P"), (12, 13, "Q")]
    assert spans.overlap_by_name([(1, 3), (9, 12.5)], got) == \
        pytest.approx({"P": 2, "C": 1, "none": 2, "Q": 0.5})


def test_without_a_slice_the_device_metric_reads_nothing(rec):
    rec.record("engine.step", 12.0, 13.0)
    assert read("model_exec.launch_idle_share", make_run()) is None


# --------------------------------------------------------------------------
# a checkout whose program has no recorder
# --------------------------------------------------------------------------

def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import sys

    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    run = traced(SLICE, window=(95.0, 101.0))
    run.measured = [rec_of(1)]
    t0 = time.monotonic()
    assert [read(n, run) for n in NEW] == [None] * 4
    assert "idle" not in vars(run)["_program_spans"]     # nothing read
    assert time.monotonic() - t0 < 5.0


# --------------------------------------------------------------------------
# a smoke cell on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return smoke.make(tmp_path_factory.mktemp("bench") / "checkout")


@pytest.fixture(scope="module")
def smoke_run(copy):
    return harness.run_cell(smoke.SMOKE_CHAT, 2**31 + 91, 2.0, False,
                            t_start=time.monotonic(), device="cpu",
                            root=copy, log=lambda *a, **k: None)


def test_a_smoke_run_reports_the_host_clock_span_metrics(smoke_run):
    res = smoke_run
    assert res["check"]["correct"]
    host = harness.info(res["run"], res)["per_layer_host"]
    assert set(NEW[:3]) <= set(host)
    assert NEW[3] not in host                    # needs the card's trace
    assert 0 <= host["driver.inbox_wait_p75_ms"] < math.inf
    assert 0 <= host["engine.queue_wait_p75_ms"] < math.inf
    assert 0 <= host["sched.empty_round_share"] <= 100


def matched(inner, outer) -> int:
    """Pairs of an interval of ``inner`` inside one of ``outer``, each
    used once; both lists disjoint (t0, t1) in order, either may hold
    intervals with no pair."""
    i = j = n = 0
    while i < len(inner) and j < len(outer):
        (a, b), (c, d) = inner[i], outer[j]
        if c <= a and b <= d:
            i, j, n = i + 1, j + 1, n + 1
        elif a < c:
            i += 1
        else:
            j += 1
    return n


def test_the_program_spans_match_the_benchmarks_wrappers(smoke_run):
    """In a run through the harness, the program's ``engine.step``,
    ``sched.form_batch`` and ``model_exec.launch`` spans and each
    request's ``request.queued`` hit against ``bench/trace.py``'s wrappers
    around the same calls: each program step inside a wrapper step of its
    own (a step that finds nothing queued records nothing, so the wrapper
    has more), each wrapper ``form_batch`` of a recorded step inside the
    program's span (stamped at the engine's call, outside the policy),
    and the model calls one for one."""
    run = smoke_run["run"]
    inst = run.inst
    lo, hi = inst.steps[0][0], inst.steps[-1][1]
    mine = [s for s in spans.program_spans(run) if lo <= s.t0 and s.t1 <= hi]

    def named(name):
        return [(s.t0, s.t1) for s in mine if s.name == name]
    steps, forms = named("engine.step"), named("sched.form_batch")
    assert 0 < len(steps) == matched(steps, inst.steps) < len(inst.steps)
    assert len(forms) == matched(inst.forms, forms) == len(steps)
    # every step that formed no batch while work was held is recorded
    assert matched(steps, inst.empty_steps) == len(inst.empty_steps)
    launches = [s for s in mine if s.name == "model_exec.launch"]
    assert [(s.attrs["kind"], s.attrs["rows"]) for s in launches] == \
        [(k, len(rows)) for _, _, k, rows in inst.model]
    for s, (a, b, _, rows) in zip(launches, inst.model):
        assert a <= s.t0 <= s.t1 <= b
        assert s.attrs["tokens"] == sum(n for _, n, _ in rows)
    queued = {s.rid: s.attrs["hit"] for s in spans.program_spans(run)
              if s.name == "request.queued" and s.rid in inst.hits}
    assert queued == inst.hits and sum(queued.values()) > 0


def test_a_smoke_run_splits_each_ttft(smoke_run):
    run = smoke_run["run"]
    got = spans.ttft_split(run)
    assert got["n"] == sum(1 for r in run.measured if not r.failed) > 0
    assert all(0 <= got[k][0] <= got[k][1] for k in spans.TTFT_PARTS)
    assert got["prefill"][0] > 0 and got["decode_per_token"][0] > 0
