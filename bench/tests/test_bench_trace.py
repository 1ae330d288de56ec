"""The reduction of a device trace: the slice between the two markers,
busy time as the union of operations, and idle gaps named by what the
engine's host thread was doing."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench.trace import MARKER, DeviceTrace


def _inst(steps=(), forms=(), model=()):
    return SimpleNamespace(steps=list(steps), forms=list(forms),
                           model=list(model))


def test_busy_is_the_union_inside_the_markers():
    # device clock = host clock (s) * 1e6 + 500 us; markers at 10 s, 11 s
    off = 500.0
    ev = [(MARKER + "(long)", 10e6 + off, 10e6 + off + 1),
          ("gemm", 10e6 + off - 100, 10e6 + off + 200_000),  # cut at lo
          ("attn", 10e6 + off + 100_000, 10e6 + off + 300_000),  # overlaps
          ("Memcpy HtoD", 10e6 + off + 600_000, 10e6 + off + 700_000),
          ("late", 11e6 + off + 10, 11e6 + off + 50),            # outside
          (MARKER + "(long)", 11e6 + off, 11e6 + off + 1)]
    tr = DeviceTrace.read(ev, [10.0, 11.0], _inst())
    assert tr.wall_s == pytest.approx(1.0)
    assert tr.busy_s == pytest.approx(0.4)
    assert tr.offset_us == pytest.approx(off)
    assert set(tr.by_name) == {"gemm", "attn", "Memcpy HtoD"}
    assert tr.by_name["gemm"][0] == pytest.approx(0.2)
    assert sum(tr.idle_by_host.values()) == pytest.approx(0.6)


def test_gaps_are_named_by_the_host_span_at_their_middle():
    off = 0.0
    ev = [(MARKER, 0.0, 1.0), ("k", 0.0, 100_000.0),
          ("k", 300_000.0, 400_000.0), ("k", 600_000.0, 1_000_000.0),
          (MARKER, 1_000_000.0, 1_000_001.0)]
    # gap (0.1, 0.3) s: form_batch at 0.2; gap (0.4, 0.6): no span
    inst = _inst(steps=[(0.15, 0.25)], forms=[(0.19, 0.21)])
    tr = DeviceTrace.read(ev, [0.0, 1.0], inst)
    assert tr.idle_by_host == pytest.approx(
        {"sched.form_batch": 0.2, "driver.between_steps": 0.2})
    assert tr.offset_us == off


def test_a_late_marker_does_not_move_the_clock():
    # the end marker waited 300 us for a free SM: the least offset holds
    ev = [(MARKER, 1e6 + 20, 1e6 + 21), (MARKER, 2e6 + 320, 2e6 + 321)]
    tr = DeviceTrace.read(ev, [1.0, 2.0], _inst())
    assert tr.offset_us == pytest.approx(20.0)
    assert tr.marker_skew_us == pytest.approx(300.0)


def test_no_markers_reads_nothing():
    assert DeviceTrace.read([("k", 0.0, 1.0)], [0.0, 1.0], _inst()) is None
