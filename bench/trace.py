"""Instruments of a run, all placed from the benchmark's own files around
the program's calls (no file of the program changes).

In every run, traced or not, so that the two differ only by the
profiler:

* host-clock spans of ``Engine.step`` (apart: the steps that formed no
  batch), the policy's ``form_batch`` and the engine's packed-prefill
  and fused-decode calls, with the host-side shapes of each (context and
  chunk lengths);
* the paged pool's blocks in use after each step;
* ``Engine.add_request``: the prompt tokens each request found in the
  prefix cache;
* the calls into the two attention entry points of ``kernels/ops.py``
  as the model makes them, counted inside the profiled slice.

In a ``--trace 1`` run on a card, also ``torch.profiler`` with CUDA
activity only (no CPU op is recorded, so the host runs as in an
untraced run).  It is prepared during set-up, so that loading CUPTI
falls before the first arrival, starts recording ``SLICE_S`` seconds
before the window closes, and is stopped only once the engine has
stopped: the stop synchronises the card and reads every buffer, which
takes tens of seconds and would otherwise hold the requests still
running.  A one-thread marker kernel on a side
stream at each end of the slice ties the device's clock to the host's.
The trace is reduced to busy time, time by kernel name and idle gaps,
each gap named by what the engine's thread was doing on the host.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Optional

import torch

SLICE_S = 5.0          # profiled slice: the last SLICE_S s of the window
MARKER = "spin_kernel"  # the kernel torch.cuda._sleep launches


def _span(store: list, fn):
    def wrapped(*a, **kw):
        t0 = time.monotonic()
        try:
            return fn(*a, **kw)
        finally:
            store.append((t0, time.monotonic()))
    return wrapped


class Instruments:
    def __init__(self, eng, arch):
        self.eng, self.arch = eng, arch
        self.steps: list = []        # (t0, t1) of Engine.step
        self.empty_steps: list = []  # (t0, t1) of the steps with no batch
        self.forms: list = []        # (t0, t1) of form_batch
        self.model: list = []        # (t0, t1, kind, rows)
        self.pool_used: list = []    # (t, blocks in use) after each step
        self.hits: dict = {}         # rid -> prompt tokens from the cache
        self.calls: dict = defaultdict(int)   # kernel entry -> calls
        self.recording = False       # inside the profiled slice
        self.slice: Optional[tuple] = None    # (t0, t1) host monotonic
        self.markers: list = []      # host monotonic of each marker launch
        self.stalls: list = []       # (t0, t1): the profiler's start
        self.stop_s = 0.0            # host time of the profiler's stop
        self._prof = None
        self._stream = None
        self._undo: list = []

    # --- patching ------------------------------------------------------
    def _patch(self, obj, name, new):
        self._undo.append((obj, name, getattr(obj, name),
                           name in vars(obj)))
        setattr(obj, name, new)

    def install(self) -> None:
        from repro_torch.serving import model_exec
        eng = self.eng
        pool = eng.pool

        step = eng.step

        def step_wrapped():
            t0 = time.monotonic()
            res = step()
            t1 = time.monotonic()
            self.steps.append((t0, t1))
            if res is None:
                if eng.has_work():
                    self.empty_steps.append((t0, t1))
            else:
                self.pool_used.append((t1, pool.num_blocks - 1
                                       - len(pool.free)))
            return res
        self._patch(eng, "step", step_wrapped)
        self._patch(eng.policy, "form_batch",
                    _span(self.forms, eng.policy.form_batch))
        add = eng.add_request

        def add_request(req, prompt, prior_outputs=None):
            add(req, prompt, prior_outputs=prior_outputs)
            self.hits[req.rid] = int(req.prefilled)
        self._patch(eng, "add_request", add_request)

        def model_call(kind, fn, rows_of):
            def wrapped(entries, emitted):
                rows = rows_of(entries)
                t0 = time.monotonic()
                try:
                    return fn(entries, emitted)
                finally:
                    self.model.append((t0, time.monotonic(), kind, rows))
            return wrapped

        # rows: (context before the call, tokens computed, logits needed)
        self._patch(eng, "_run_prefill_packed", model_call(
            "prefill", eng._run_prefill_packed,
            lambda es: [(e.l_kv, e.n_tokens,
                         e.l_kv + e.n_tokens >= e.req.prompt_len
                         and e.req.generated == 0) for e in es]))
        self._patch(eng, "_run_decode", model_call(
            "decode", eng._run_decode,
            lambda es: [(e.l_kv, 1, True) for e in es]))
        for name in ("paged_decode_attention", "packed_prefill_attention"):
            self._patch(model_exec, name,
                        self._counted(name, getattr(model_exec, name)))

    def uninstall(self) -> None:
        """Undo the wrappers and let go of the engine, so that its pool
        is freed before the reference runs."""
        for obj, name, old, own in reversed(self._undo):
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.clear()
        self.eng = None

    def _counted(self, name, fn):
        def wrapped(*a, **kw):
            if self.recording:
                self.calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    # --- the profiled slice ---------------------------------------------
    def prepare_profiler(self) -> None:
        """Set-up of a traced run: the profiler loads and arms CUPTI now,
        before the first arrival, and records nothing yet."""
        from torch.profiler import ProfilerActivity, profile
        self._stream = torch.cuda.Stream(priority=-1)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.prepare_trace()

    def _marker(self) -> None:
        with torch.cuda.stream(self._stream):
            self.markers.append(time.monotonic())
            torch.cuda._sleep(1000)

    async def start_slice(self, w_end: float) -> None:
        """Start recording the device at ``w_end - SLICE_S``."""
        import asyncio
        if self._prof is None:
            return
        await asyncio.sleep(max(0.0, w_end - SLICE_S - time.monotonic()))
        a = time.monotonic()
        self._prof.start_trace()
        self._marker()
        self.stalls.append((a, time.monotonic()))
        self.recording = True

    def end_slice(self) -> None:
        """As the window closes: the end marker."""
        if self._prof is None or not self.recording:
            return
        self.recording = False
        self._marker()
        self.slice = (self.markers[0], self.markers[1])

    def stop_profiler(self) -> None:
        """Once the engine has stopped: read the profiler's buffers."""
        if self._prof is None:
            return
        t0 = time.monotonic()
        self._prof.stop_trace()
        self.stop_s = time.monotonic() - t0

    def device_trace(self) -> Optional["DeviceTrace"]:
        if self._prof is None or self.slice is None:
            return None
        t0 = time.monotonic()
        dev = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns() / 1e3,
                   (e.start_ns() + e.duration_ns()) / 1e3)
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == dev]
        return DeviceTrace.read(events, self.markers, self,
                                time.monotonic() - t0)


@dataclasses.dataclass
class DeviceTrace:
    wall_s: float                 # the slice, between the markers
    busy_s: float                 # union of device kernels and copies
    by_name: dict                 # name -> [seconds, count]
    idle_by_host: dict            # what the engine's host thread did
    offset_us: float              # device clock minus host clock
    marker_skew_us: float         # the two markers' offsets apart
    reduce_s: float               # time taken to read the trace

    @staticmethod
    def read(events: list, markers: list, inst,
             reduce_s: float = 0.0) -> Optional["DeviceTrace"]:
        """``events``: (name, start_us, end_us) of every device operation;
        ``markers``: host monotonic seconds of the two marker launches.
        None where the trace lacks either marker."""
        marks = sorted(a for n, a, _ in events if MARKER in n)
        if len(marks) < 2 or len(markers) < 2:
            return None
        lo, hi = marks[0], marks[-1]
        offs = [d - 1e6 * h for d, h in zip((lo, hi), markers)]
        off = min(offs)     # a marker waits for a free SM: take the least
        spans, by_name = [], {}
        for name, a, b in events:
            if MARKER in name:
                continue
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            spans.append((a, b))
            row = by_name.setdefault(name, [0.0, 0])
            row[0] += (b - a) / 1e6
            row[1] += 1
        spans.sort()
        busy, gaps, cur_a, cur_b = 0.0, [], lo, lo
        for a, b in spans:
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a = a
            cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        if hi > cur_b:
            gaps.append((cur_b, hi))
        idle = _label_gaps(gaps, off, inst)
        return DeviceTrace((hi - lo) / 1e6, busy / 1e6, by_name, idle, off,
                           abs(offs[1] - offs[0]), reduce_s)


def _label_gaps(gaps: list, off: float, inst) -> dict:
    """Idle device time by what the engine's thread was doing at each gap's
    middle: the policy's ``form_batch``, launching a model call, the rest
    of ``Engine.step``, or the driver loop between steps."""
    def index(spans):
        spans = sorted(spans)
        return [s[0] for s in spans], spans

    labelled = [("sched.form_batch", index(inst.forms)),
                ("model_exec.host", index([(m[0], m[1])
                                           for m in inst.model])),
                ("engine.step.other", index(inst.steps))]
    out: dict = defaultdict(float)
    for a, b in gaps:
        mid = ((a + b) / 2 - off) / 1e6          # host monotonic
        name = "driver.between_steps"
        for label, (starts, spans) in labelled:
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and spans[i][1] >= mid:
                name = label
                break
        out[name] += (b - a) / 1e6
    return dict(out)
