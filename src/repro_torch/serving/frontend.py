"""Asynchronous service tier: admission control + GoRouting dispatch over a
fleet of threaded engine replicas, streaming tokens to asyncio consumers.

Architecture (the Ray-Serve LLMRouter/LLMServer split, adapted):

    client coroutine ──submit()──► ServiceFrontend (asyncio, ingress)
                                      │  admission control (per-priority)
                                      │  GoRouting select + RouterBook
                                      ▼
                             EngineDriver inbox (per replica, thread-safe)
                                      │  driver thread: continuous batching
                                      ▼
                             Engine.step() ──TokenEvent──► sink
                                      │   call_soon_threadsafe
                                      ▼
                             RequestStream (asyncio.Queue) ──► client

Every request is admitted against per-priority in-flight quotas (reject
fast, or await a slot with ``wait=True`` — backpressure), dispatched by the
router to one replica's inbox, and streamed back as :class:`TokenEvent`s.
The stream records *client-edge* receive times so TTFT/TPOT attainment is
measured where a user would measure it, not inside the engine.

Fault tolerance mirrors the synchronous ``ServiceController``: every
request is logged at admission; ``kill_instance`` re-dispatches orphans
with their already-streamed tokens as ``prior_outputs`` so generation
resumes exactly (the client stream never notices beyond added latency).

Port of ``repro.serving.frontend`` over the port's ``RouterBook``,
``Engine`` and ``EngineDriver``.  One departure, kept on purpose: when
a driver thread raises (the reference's dies silently, and ``drain``
then only times out), its replica leaves the book, the streams it held
are closed with its error, and ``drain`` and ``stop`` raise
``DriverDied`` with the thread's exception as the cause.
"""
from __future__ import annotations

import asyncio
import itertools
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator, Optional

import numpy as np

from ..core.estimator import BatchLatencyEstimator
from ..core.gorouting import pick_decode_target
from ..core.request import Request
from .dispatch import RouterBook
from .engine import (DriverFailed, Engine, EngineDriver, HandoffAdopted,
                     HandoffDropped, HandoffEvent, HandoffPayload, StepEvent,
                     TokenEvent)


class AdmissionError(RuntimeError):
    """Request rejected at the ingress (quota exhausted or no live replica)."""

    def __init__(self, msg: str, *, priority: Optional[int] = None,
                 inflight: Optional[int] = None,
                 limit: Optional[int] = None):
        super().__init__(msg)
        self.priority = priority
        self.inflight = inflight
        self.limit = limit


@dataclass
class FrontendConfig:
    max_inflight: int = 512            # global admission cap
    # per-priority in-flight quotas; priorities absent from the map share
    # the global cap only.  This is the backpressure isolation: a flood of
    # low-priority traffic cannot consume high-priority admission slots.
    priority_quota: Optional[dict] = None
    speed_ewma: float = 0.2            # straggler EWMA (RouterBook)
    driver_idle_wait: float = 2e-3     # driver park interval when idle


class RequestStream:
    """Async iterator over one request's :class:`TokenEvent`s.

    Records client-edge receive stamps: ``ttft``/``tpot`` here include
    queueing, dispatch, batching and the thread→loop hop — everything a
    real client would see.
    """

    def __init__(self, req: Request, loop: asyncio.AbstractEventLoop):
        self.request = req
        self._loop = loop
        self._q: asyncio.Queue = asyncio.Queue()
        self.submitted = time.monotonic()
        self.tokens: list[int] = []
        self.recv_times: list[float] = []
        self.done = False
        self._error: Optional[BaseException] = None

    # -- producer side (loop thread, via call_soon_threadsafe) ----------
    def _push(self, ev: TokenEvent) -> None:
        self._q.put_nowait(ev)

    def _close(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        self._q.put_nowait(None)

    # -- consumer side ---------------------------------------------------
    def __aiter__(self) -> AsyncIterator[TokenEvent]:
        return self

    async def __anext__(self) -> TokenEvent:
        if self.done:
            raise StopAsyncIteration
        ev = await self._q.get()
        if ev is None:
            self.done = True
            if self._error is not None:
                raise self._error
            raise StopAsyncIteration
        self.tokens.append(ev.token)
        self.recv_times.append(time.monotonic())
        if ev.last:
            self.done = True
        return ev

    async def collect(self) -> list[int]:
        """Drain the stream; returns all tokens."""
        async for _ in self:
            pass
        return self.tokens

    # -- client-edge latency metrics -------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        return (self.recv_times[0] - self.submitted
                if self.recv_times else None)

    @property
    def tpot(self) -> Optional[float]:
        if len(self.recv_times) < 2:
            return None
        span = self.recv_times[-1] - self.recv_times[0]
        return span / (len(self.recv_times) - 1)

    def met_slo(self) -> bool:
        slo = self.request.slo
        if self.ttft is None or self.ttft >= slo.ttft:
            return False
        t = self.tpot
        return True if t is None else t < slo.tpot

    @property
    def complete(self) -> bool:
        """All expected tokens received (not closed early / truncated)."""
        return len(self.tokens) >= self.request.output_len

    def as_request(self) -> Request:
        """Clone with client-edge timing, for ``sim.metrics.summarize``.
        Keeps the TRUE output_len: a stream truncated by an abort scores
        as unfinished, not as a short successful request."""
        r = Request(prompt_len=self.request.prompt_len,
                    output_len=max(1, self.request.output_len),
                    arrival=0.0, slo=self.request.slo,
                    priority=self.request.priority,
                    weight=self.request.weight,
                    client=self.request.client)
        for t in self.recv_times:
            r.emit_token(t - self.submitted)
        return r


class ServiceFrontend:
    """Async ingress over N threaded engine replicas (see module doc)."""

    def __init__(self, router, est: BatchLatencyEstimator,
                 cfg: FrontendConfig = FrontendConfig()):
        self.cfg = cfg
        self.book = RouterBook(router, est, speed_ewma=cfg.speed_ewma)
        self.drivers: dict[int, EngineDriver] = {}
        self.killed: dict[int, EngineDriver] = {}   # kill_instance'd
        self._iid = itertools.count()
        self._epoch = time.monotonic()
        self._lock = threading.Lock()       # guards book + maps + counters
        self._streams: dict[int, RequestStream] = {}
        self._reqs: dict[int, Request] = {}
        self._rid_iid: dict[int, int] = {}
        self._inflight: dict[int, int] = {}
        self._total_inflight = 0
        self._slot_events: dict[int, asyncio.Event] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.finished: list[Request] = []
        self.completed_streams: list[RequestStream] = []
        self.rejected = 0
        self._started = False

    # --- fleet management -----------------------------------------------
    def add_instance(self, engine: Engine) -> int:
        """Register a replica; spawns its driver thread if started."""
        iid = next(self._iid)
        engine.use_wall_clock(self._epoch)
        driver = EngineDriver(iid, engine, self._make_sink(iid),
                              idle_wait=self.cfg.driver_idle_wait)
        with self._lock:
            self.drivers[iid] = driver
            self.book.add_instance(iid, engine.bm.num_device_blocks,
                                   engine.bm.free_blocks,
                                   has_prefix_cache=engine.cache is not None,
                                   role=engine.role)
        if self._started:
            driver.start()
        return iid

    def kill_instance(self, iid: int) -> list[Request]:
        """Hard failure: stop the driver, re-dispatch orphans from the log
        with their already-emitted tokens (generation resumes exactly).
        Returns the orphans (the reference returns nothing)."""
        driver = self.drivers.pop(iid, None)
        if driver is None:
            return []
        self.killed[iid] = driver
        with self._lock:
            self.book.drop_instance(iid)
        orphans = driver.kill()
        for req in orphans:
            self._redispatch(req)
        return orphans

    def _redispatch(self, req: Request) -> None:
        logged = self.book.request_log.get(req.rid)
        if logged is None:
            return
        # resume from the durable log, not the dead engine's memory: an
        # orphan still sitting in an inbox (double failover) has no
        # engine.outputs entry, but the log always has every streamed token.
        _, prompt, partial = logged
        partial = list(partial)
        with self._lock:
            iid = self.book.route(req, self._now(), prompt_tokens=prompt)
            if iid is None:
                stream = self._streams.pop(req.rid, None)
                self.book.forget(req.rid)
                self._release_slot(req)
                if stream is not None and self._loop is not None:
                    self._loop.call_soon_threadsafe(
                        stream._close,
                        AdmissionError("no live replica for failover",
                                       priority=req.priority))
                return
            self._rid_iid[req.rid] = iid
            driver = self.drivers[iid]
        driver.submit(req, prompt, prior_outputs=partial)

    @property
    def engines(self) -> dict[int, Engine]:
        return {iid: d.engine for iid, d in self.drivers.items()}

    # --- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._started = True
        for d in self.drivers.values():
            d.start()

    async def stop(self) -> None:
        """Stop every driver; then raise ``DriverDied`` if one had died."""
        self._started = False
        for d in self.drivers.values():
            d._join(10.0)
        # wake any consumer still waiting on a stream
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            if not s.done:
                s._close()
        self.check_drivers()

    def check_drivers(self) -> None:
        """Raise ``DriverDied`` if any driver thread (live or killed)
        raised."""
        for d in (*self.drivers.values(), *self.killed.values()):
            d.check()

    async def drain(self, timeout: float = 120.0) -> bool:
        """Wait until every admitted request has finished streaming;
        raises ``DriverDied`` as soon as a driver thread has died."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.check_drivers()
            with self._lock:
                if self._total_inflight == 0:
                    return True
            await asyncio.sleep(2e-3)
        self.check_drivers()
        return False

    def _now(self) -> float:
        return time.monotonic() - self._epoch

    # --- admission control -----------------------------------------------
    def _quota(self, priority: int) -> int:
        if self.cfg.priority_quota and priority in self.cfg.priority_quota:
            return self.cfg.priority_quota[priority]
        return self.cfg.max_inflight

    def _admit(self, priority: int) -> bool:
        return (self._total_inflight < self.cfg.max_inflight
                and self._inflight.get(priority, 0) < self._quota(priority))

    def _release_slot(self, req: Request) -> None:
        """Caller holds the lock."""
        self._total_inflight -= 1
        self._inflight[req.priority] -= 1
        self._reqs.pop(req.rid, None)
        self._rid_iid.pop(req.rid, None)
        if self._loop is not None:
            ev = self._slot_events.get(req.priority)
            if ev is not None:
                self._loop.call_soon_threadsafe(ev.set)

    # --- ingress ----------------------------------------------------------
    async def submit(self, req: Request, prompt_tokens,
                     *, wait: bool = False,
                     stamp_arrival: bool = True) -> RequestStream:
        """Admit + dispatch one request; returns its token stream.

        ``wait=False``: reject immediately with :class:`AdmissionError`
        when the priority's quota (or the global cap) is exhausted.
        ``wait=True``: apply backpressure instead — suspend this coroutine
        until a slot of the same priority frees up.
        """
        if self._loop is None:
            raise RuntimeError("frontend not started — await start() first")
        p = req.priority
        while True:
            with self._lock:
                if self._admit(p):
                    self._total_inflight += 1
                    self._inflight[p] = self._inflight.get(p, 0) + 1
                    break
                if not wait:
                    self.rejected += 1
                    raise AdmissionError(
                        f"priority {p} at quota "
                        f"({self._inflight.get(p, 0)}/{self._quota(p)}, "
                        f"total {self._total_inflight}"
                        f"/{self.cfg.max_inflight})",
                        priority=p, inflight=self._inflight.get(p, 0),
                        limit=self._quota(p))
                ev = self._slot_events.setdefault(p, asyncio.Event())
                ev.clear()
            await ev.wait()

        now = self._now()
        if stamp_arrival:
            req.arrival = now
        stream = RequestStream(req, self._loop)
        prompt_arr = np.asarray(prompt_tokens, np.int32)
        with self._lock:
            self.book.log_request(req, prompt_arr)
            iid = self.book.route(req, now, prompt_tokens=prompt_arr)
            if iid is None:
                self.book.forget(req.rid)
                self._release_slot(req)
                self.rejected += 1
                raise AdmissionError("no live replica", priority=p)
            self._streams[req.rid] = stream
            self._reqs[req.rid] = req
            self._rid_iid[req.rid] = iid
            driver = self.drivers[iid]
        driver.submit(req, prompt_arr)
        return stream

    # --- event sink (driver threads) ---------------------------------------
    def _make_sink(self, iid: int):
        def sink(ev) -> None:
            if isinstance(ev, TokenEvent):
                self._on_token(iid, ev)
            elif isinstance(ev, StepEvent):
                self._on_step(ev)
            elif isinstance(ev, HandoffEvent):
                self._on_handoff(iid, ev.payload)
            elif isinstance(ev, HandoffAdopted):
                self._on_handoff_adopted(ev.iid, ev.payload)
            elif isinstance(ev, HandoffDropped):
                self._redispatch(ev.payload.req)
            elif isinstance(ev, DriverFailed):
                self._on_driver_failed(ev)
        return sink

    def _on_driver_failed(self, ev: DriverFailed) -> None:
        """Route nothing more to the dead replica, and close every stream
        routed to it with its error, so no consumer waits for tokens that
        will never come."""
        with self._lock:
            self.book.drop_instance(ev.iid)
            dead = [rid for rid, iid in self._rid_iid.items()
                    if iid == ev.iid]
            streams = [self._streams.pop(rid, None) for rid in dead]
        if self._loop is not None:
            for stream in streams:
                if stream is not None:
                    self._loop.call_soon_threadsafe(stream._close, ev.error)

    # --- disagg two-leg lifecycle (driver threads) ------------------------
    def _on_handoff(self, src_iid: int, payload: HandoffPayload) -> None:
        """A prefill replica exported a payload: forward it to the decode
        replica reserved at admission — or, if that replica died mid-
        handoff, to the best surviving decode replica; with none left,
        fail over to a re-prefill (which route() lands on a coloc
        replica via the durable log)."""
        rid = payload.req.rid
        with self._lock:
            self.book.on_handoff_sent(src_iid, rid, self._now())
            d_iid = self.book.decode_target(rid)
            driver = self.drivers.get(d_iid) if d_iid is not None else None
            if driver is None:
                d_pool = [st for st in self.book.states.values()
                          if st.role == "decode"]
                d_iid = pick_decode_target(d_pool, payload.req,
                                           self.book.block_size)
                driver = (self.drivers.get(d_iid)
                          if d_iid is not None else None)
            if driver is not None:
                self._rid_iid[rid] = d_iid
        if driver is not None:
            driver.submit_handoff(payload)
        else:
            self._redispatch(payload.req)

    def _on_handoff_adopted(self, iid: int, payload: HandoffPayload) -> None:
        with self._lock:
            self.book.on_handoff_delivered(
                payload.req.rid, iid, payload.n_blocks,
                payload.wire_bytes, self._now())

    def _on_token(self, iid: int, ev: TokenEvent) -> None:
        with self._lock:
            stream = self._streams.get(ev.rid)
            logged = self.book.request_log.get(ev.rid)
            if logged is not None:       # stream into the durable log
                logged[2].append(ev.token)
        if stream is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(stream._push, ev)

    def _on_step(self, ev: StepEvent) -> None:
        now = self._now()
        with self._lock:
            self.book.observe_step(ev.iid, free_blocks=ev.free_blocks,
                                   est_time=ev.est_time, latency=ev.latency)
            for rid in ev.prefill_done:
                self.book.on_first_token(ev.iid, rid, now)
            for rid in ev.finished:
                req = self._reqs.get(rid)
                self.book.on_finished(ev.iid, rid)
                stream = self._streams.pop(rid, None)
                if stream is not None:
                    self.completed_streams.append(stream)
                if req is not None:
                    self.finished.append(req)
                    self._release_slot(req)

    # --- reporting ----------------------------------------------------------
    def client_edge_requests(self) -> list[Request]:
        """Completed streams as Requests stamped with client-edge times —
        feed straight into ``repro_torch.sim.metrics.summarize``."""
        return [s.as_request() for s in self.completed_streams]
