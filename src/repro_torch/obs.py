"""Spans of the serving path, recorded inside the program.

One process-wide ``Recorder`` (``recorder()``) keeps every span in a
bounded ring.  A span has a name, a start and an end on
``time.monotonic()`` (the host clock that a device trace's marker kernels
are stamped on, so spans map onto the device timeline), its own id, the id
of the span that caused it, the thread that recorded it, an optional
request id and a few integer or short-string attributes.

Two ways to record:

* ``with span(name, **attrs) as s:`` around work on one thread; the
  thread's innermost open span is its parent, and ``s.set(**attrs)`` adds
  attributes known only at the end;
* ``record(name, t0, t1, ...)`` for an interval whose ends were stamped
  apart, such as a request's wait between two threads; its parent is the
  recording thread's innermost open span unless one is given.

Spans whose name starts with ``request.`` follow one request across
threads and do not nest with the thread's own spans.

The ring holds ``CAPACITY`` spans, the last few minutes of a serving
engine: at ~20 spans a step and ~15 steps a second, about three and a
half minutes, in ~20 MB (~300 bytes a span).  Past it the oldest spans
are dropped.  ``set_enabled(False)`` turns recording off: ``span``
then hands back a shared no-op (``quiet`` always does) and ``record``
returns at once.
``Recorder.export_chrome(path)`` writes the spans as a Chrome / Perfetto
trace.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from threading import get_ident
from typing import NamedTuple, Optional

CAPACITY = 1 << 16
REQUEST = "request."


class Span(NamedTuple):
    name: str
    t0: float                 # time.monotonic(), seconds
    t1: float
    sid: int
    parent: int               # 0: none
    thread: int               # threading.get_ident() of the recorder
    rid: Optional[int]
    attrs: Optional[dict]


_new = tuple.__new__


class _Open:
    """A span being recorded on the current thread."""
    __slots__ = ("rec", "name", "rid", "attrs", "stack", "sid", "parent",
                 "t0")

    def __init__(self, rec, name, rid, attrs):
        self.rec, self.name, self.rid, self.attrs = rec, name, rid, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.stack = stack = self.rec._stack()
        self.parent = stack[-1] if stack else 0
        self.sid = next(self.rec._ids)
        stack.append(self.sid)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        self.stack.pop()
        self.rec._ring.append(_new(Span, (
            self.name, self.t0, t1, self.sid, self.parent, get_ident(),
            self.rid, self.attrs or None)))
        return False


class _Off:
    """What ``span`` hands back while recording is off."""
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def quiet(*args, **attrs) -> _Off:
    """``span``'s stand-in where a caller records nothing this time: the
    shared no-op."""
    return _OFF


class Recorder:
    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = True
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._names: dict[int, str] = {}

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            t = threading.current_thread()
            self._names[t.ident] = t.name
            return self._local.stack

    # --- recording ------------------------------------------------------
    def span(self, name: str, rid: Optional[int] = None, **attrs):
        if not self.enabled:
            return _OFF
        return _Open(self, name, rid, attrs)

    def record(self, name: str, t0: float, t1: float,
               rid: Optional[int] = None, parent: Optional[int] = None,
               **attrs) -> None:
        if not self.enabled:
            return
        stack = self._stack()
        if parent is None:
            parent = stack[-1] if stack else 0
        self._ring.append(_new(Span, (name, t0, t1, next(self._ids), parent,
                                      get_ident(), rid, attrs or None)))

    def current(self) -> int:
        """The id of this thread's innermost open span (0: none), to pass
        as the ``parent`` of work handed to another thread."""
        if not self.enabled:
            return 0
        stack = self._stack()
        return stack[-1] if stack else 0

    # --- reading --------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> list[Span]:
        """The spans held, oldest first (all, or those named ``name``)."""
        held = list(self._ring)
        return held if name is None else [s for s in held if s.name == name]

    def thread_name(self, ident: int) -> str:
        return self._names.get(ident, str(ident))

    def export_chrome(self, path) -> None:
        """Write the spans held as a Chrome / Perfetto trace (JSON, times in
        microseconds on the monotonic clock).  A thread's spans are complete
        events on its track; ``request.*`` spans are async events keyed by
        their request id."""
        pid = os.getpid()
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in self._names.items()]
        for s in self.spans():
            args = dict(s.attrs or {}, sid=s.sid, parent=s.parent)
            if s.rid is not None:
                args["rid"] = s.rid
            common = {"name": s.name, "cat": s.name.split(".")[0],
                      "pid": pid, "tid": s.thread}
            if s.name.startswith(REQUEST):
                out.append(dict(common, ph="b", id=s.rid, ts=s.t0 * 1e6,
                                args=args))
                out.append(dict(common, ph="e", id=s.rid, ts=s.t1 * 1e6))
            else:
                out.append(dict(common, ph="X", ts=s.t0 * 1e6,
                                dur=(s.t1 - s.t0) * 1e6, args=args))
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms",
                       "otherData": {"clock": "time.monotonic"}}, f)


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process-wide recorder."""
    return _RECORDER


def set_enabled(on: bool) -> None:
    _RECORDER.enabled = bool(on)


span = _RECORDER.span
record = _RECORDER.record
current = _RECORDER.current
