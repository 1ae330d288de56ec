"""The program's own spans (``repro_torch.obs``) as the per-layer readers
see them, and the profiled slice's device idle time put down to the span
the engine's thread was in.

The spans are read from the program's process-wide recorder, the device
intervals from the profiler's events (``run.inst._prof``), each once per
run, and cached on the run.  A span stamps ``time.monotonic()``, the
clock of the slice's marker kernels, so ``run.prof.offset_us`` maps it
onto the device's clock.  Where the program has no recorder (a checkout
from before it had one) every reading is None and nothing is read.
"""
from __future__ import annotations

import math
import time
from collections import Counter

from . import measure, yardstick
from .trace import MARKER

NONE = "none"                 # idle time in no span of the engine's thread
REQUEST = "request."           # the spans that follow one request


def _cache(run) -> dict:
    return vars(run).setdefault("_program_spans", {})


def program_spans(run):
    """Every span the program's recorder holds, or None without one."""
    c = _cache(run)
    if "spans" not in c:
        try:
            from repro_torch import obs
        except ImportError:
            c["spans"] = None
        else:
            c["spans"] = obs.recorder().spans()
    return c["spans"]


def in_window(run, name: str):
    """Spans named ``name`` that began and ended inside the window."""
    spans = program_spans(run)
    if spans is None:
        return None
    a, b = run.window
    return [s for s in spans if s.name == name and a <= s.t0 and s.t1 <= b]


def request_p75_ms(run, name: str):
    """75th percentile, ms, of the ``name`` span of each request due in the
    window that reached the program (not refused at admission); one
    without such a span (never drained, never scheduled) ranks as failed.
    Matched by request id, so a request whose span ends after the window
    still counts.  None where the program recorded no such span at all
    (its recorder was off)."""
    spans = program_spans(run)
    if spans is None:
        return None
    dur = {s.rid: 1e3 * (s.t1 - s.t0) for s in spans if s.name == name}
    if not dur:
        return None
    vals = [dur.get(r.req.rid, math.inf) for r in run.measured
            if not (r.error or "").startswith("refused")]
    return measure.pct(vals, 75.0, 1e3 * measure.cap_s(run))


TTFT_PARTS = ("frontend", "inbox", "queued", "prefill", "to_client")


def ttft_split(run):
    """Where the measured requests' time to first token went: for each
    request that finished with all four ``request.*`` spans, its TTFT cut
    at the spans' edges into ``TTFT_PARTS`` (due time to the inbox, the
    inbox and ``add_request``, the engine's queue, the prefill, the first
    token's way to the client), which add up to its TTFT; and its decode
    time a token (``request.decode`` over its tokens after the first).
    Returns {part: (p50, p75) ms} with ``ttft``, ``decode_per_token`` and
    ``n`` (the requests counted); None without the spans."""
    spans = program_spans(run)
    if spans is None:
        return None
    by: dict = {}
    for s in spans:
        if s.name.startswith(REQUEST):
            by[s.name, s.rid] = s
    parts: dict = {k: [] for k in TTFT_PARTS + ("ttft", "decode_per_token")}
    for r in run.measured:
        got = [by.get((REQUEST + k, r.req.rid))
               for k in ("inbox", "queued", "prefill", "decode")]
        if None in got or r.failed or not r.out_times:
            continue
        inbox, queued, prefill, decode = got
        edges = (r.arrival, inbox.t0, queued.t0, prefill.t0, prefill.t1,
                 r.out_times[0])
        for k, a, b in zip(TTFT_PARTS, edges, edges[1:]):
            parts[k].append(1e3 * (b - a))
        parts["ttft"].append(1e3 * (r.out_times[0] - r.arrival))
        if len(r.out_times) > 1:
            parts["decode_per_token"].append(
                1e3 * (decode.t1 - decode.t0) / (len(r.out_times) - 1))
    if not parts["ttft"]:
        return None
    out = {k: (yardstick.percentile(v, 50.0), yardstick.percentile(v, 75.0))
           for k, v in parts.items() if v}
    out["n"] = len(parts["ttft"])
    return out


def empty_rounds(run):
    """(rounds that ran with requests queued, Counter of the reasons the
    empty ones gave) over the ``sched.form_batch`` spans in the window;
    None where there are none (no recorder, or it was off)."""
    forms = in_window(run, "sched.form_batch")
    if not forms:
        return None
    held = [s for s in forms if s.attrs and s.attrs.get("queued")]
    return len(held), Counter(s.attrs["reason"] for s in held
                              if s.attrs.get("reason"))


def empty_round_share(run):
    got = empty_rounds(run)
    if got is None:
        return None
    held, reasons = got
    return 100.0 * sum(reasons.values()) / held if held else 0.0


# --- the profiled slice -------------------------------------------------
def device_idle(run):
    """The slice's idle intervals, ``(t0, t1)`` on the host clock, s: its
    span between the two markers less the union of every other device
    operation (as ``trace.DeviceTrace`` reduces it).  None without a
    profiled slice."""
    c = _cache(run)
    if "idle" in c:
        return c["idle"]
    c["idle"] = None
    prof, inst = run.prof, run.inst
    if prof is None or getattr(inst, "_prof", None) is None \
            or inst.slice is None:
        return None
    t_read = time.monotonic()
    import torch
    dev = torch.autograd.DeviceType.CUDA
    off = prof.offset_us
    # the slice's operations, found by their start without reading every
    # event's name (the profiler holds the whole run's)
    first_ns = 1e3 * (1e6 * inst.slice[0] + off - 1e6)
    last_ns = 1e3 * (1e6 * inst.slice[1] + off + prof.marker_skew_us + 1e4)
    events = []
    for e in inst._prof.profiler.kineto_results.events():
        s = e.start_ns()
        if first_ns <= s <= last_ns and e.device_type() == dev:
            events.append((e.name(), s / 1e3,
                           (s + e.duration_ns()) / 1e3))
    c["idle"] = idle_gaps(events, off)
    c["read_s"] = time.monotonic() - t_read
    return c["idle"]


def idle_gaps(events: list, off: float):
    """``events``: (name, start_us, end_us) on the device's clock, the two
    markers among them; the gaps between the markers that no other
    operation covers, on the host clock (s).  None without both markers."""
    marks = sorted(a for n, a, _ in events if MARKER in n)
    if len(marks) < 2:
        return None
    lo, hi = marks[0], marks[-1]
    ops = sorted((max(a, lo), min(b, hi)) for n, a, b in events
                 if MARKER not in n and min(b, hi) > max(a, lo))
    gaps, cur = [], lo
    for a, b in ops:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return [((a - off) / 1e6, (b - off) / 1e6) for a, b in gaps]


def engine_thread(spans: list, window: tuple):
    """The thread that ran ``Engine.step`` inside the window."""
    a, b = window
    steps = Counter(s.thread for s in spans
                    if s.name == "engine.step" and a <= s.t0 and s.t1 <= b)
    return steps.most_common(1)[0][0] if steps else None


def innermost(spans: list) -> list:
    """``spans``: (t0, t1, name) nested as one thread's spans are; the
    time they cover as disjoint (t0, t1, name) pieces in order, each named
    by the innermost span over it."""
    out, stack, cur = [], [], -math.inf
    for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        # the spans that ended before this one began: the time up to each
        # end was the innermost open span's
        while stack and stack[-1][0] <= t0:
            end, top = stack.pop()
            if end > cur:
                out.append((cur, end, top))
                cur = end
        if stack and t0 > cur:
            out.append((cur, t0, stack[-1][1]))
        cur = max(cur, t0)
        stack.append((t1, name))
    while stack:
        end, top = stack.pop()
        if end > cur:
            out.append((cur, end, top))
            cur = end
    return out


def overlap_by_name(gaps: list, pieces: list) -> dict:
    """Seconds of ``gaps`` under each piece's name, the rest under
    ``NONE``; both lists disjoint and sorted."""
    out: dict = Counter()
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            x = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if x > 0:
                out[pieces[k][2]] += x
                covered += x
            k += 1
        out[NONE] += (b - a) - covered
    return dict(out)


def idle_by_span(run):
    """Idle device seconds of the slice by the innermost span the engine's
    thread was in (``none``: in none of them).  None without both the
    program's spans and a profiled slice."""
    c = _cache(run)
    if "by_span" in c:
        return c["by_span"]
    spans = program_spans(run)
    gaps = device_idle(run) if spans is not None else None
    thread = engine_thread(spans, run.window) if gaps is not None else None
    if thread is None:
        c["by_span"] = None
        return None
    a = gaps[0][0] if gaps else 0.0
    b = gaps[-1][1] if gaps else 0.0
    mine = [(s.t0, s.t1, s.name) for s in spans
            if s.thread == thread and not s.name.startswith(REQUEST)
            and s.t1 > a and s.t0 < b]
    c["by_span"] = overlap_by_name(gaps, innermost(mine))
    return c["by_span"]


def launch_idle_share(run):
    by = idle_by_span(run)
    if by is None:
        return None
    return measure.device_share(run, by.get("model_exec.launch", 0.0))
