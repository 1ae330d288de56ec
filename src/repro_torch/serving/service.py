"""Synchronous service layer: GoRouting dispatch over N engine replicas
(port of ``repro.serving.service`` over the port's ``Engine``).

A thin deterministic wrapper over the :class:`RouterBook` bookkeeping:
one caller thread drives every engine with ``step_all()``.  Replicas may
be colocated or split into prefill and decode roles
(``RouterConfig(pd_mode="disagg")``): a prefill replica's exported KV
payloads are delivered here to the decode replica reserved for them at
admission (or the best surviving one), and fail over to a re-prefill when
no decode replica can adopt them.

Fault-tolerance semantics: every request is appended to a durable request
log at admission, and the tokens each replica streams are mirrored into
it after every step; orphaned requests of a dead instance are
re-dispatched from the log (KV lost — recomputed, generation resumed
where it stopped); instances can be added at runtime (elastic scale-up)
and removed gracefully; an EWMA speed factor per instance feeds
GoRouting's EstimateExec so stragglers organically receive less work.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.estimator import BatchLatencyEstimator
from ..core.gorouting import pick_decode_target
from ..core.request import Request
from .dispatch import RouterBook
from .engine import Engine, HandoffPayload


@dataclass
class ServiceConfig:
    heartbeat_timeout: float = 5.0
    speed_ewma: float = 0.2


class ServiceController:
    def __init__(self, router, est: BatchLatencyEstimator,
                 cfg: ServiceConfig = ServiceConfig()):
        self.cfg = cfg
        self.book = RouterBook(router, est, speed_ewma=cfg.speed_ewma)
        self.engines: dict[int, Engine] = {}
        self.finished: list[Request] = []
        self._iid = itertools.count()
        self.now = 0.0

    # thin delegation — the book owns router-side state
    @property
    def router(self):
        return self.book.router

    @property
    def est(self) -> BatchLatencyEstimator:
        return self.book.est

    @property
    def states(self):
        return self.book.states

    @property
    def request_log(self):
        return self.book.request_log

    # --- elasticity -------------------------------------------------------
    def add_instance(self, engine: Engine) -> int:
        iid = next(self._iid)
        self.engines[iid] = engine
        self.book.add_instance(iid, engine.bm.num_device_blocks,
                               engine.bm.free_blocks,
                               has_prefix_cache=engine.cache is not None,
                               role=engine.role)
        return iid

    def remove_instance(self, iid: int, *, drain: bool = True) -> None:
        """Graceful scale-down: stop dispatching; optionally re-dispatch."""
        eng = self.engines.pop(iid, None)
        self.book.drop_instance(iid)
        if eng is None:
            return
        orphans = eng.kill()
        if drain:
            for r in orphans:
                self._redispatch(r)

    def kill_instance(self, iid: int) -> None:
        """Hard failure: engine dies, requests recovered from the log."""
        eng = self.engines.pop(iid, None)
        self.book.drop_instance(iid)
        if eng is None:
            return
        for r in eng.kill():
            self._redispatch(r)

    def _redispatch(self, req: Request) -> None:
        partial = self.book.logged_partial(req.rid)
        if partial is None:
            return
        self.submit(req, self.book.request_log[req.rid][1],
                    _relog=False, _prior=partial)

    # --- dispatch ----------------------------------------------------------
    def submit(self, req: Request, prompt_tokens: np.ndarray,
               *, _relog: bool = True, _prior: Optional[list] = None
               ) -> Optional[int]:
        if _relog:
            self.book.log_request(req, prompt_tokens)
        iid = self.book.route(req, self.now, prompt_tokens=prompt_tokens)
        if iid is None:
            return None
        self.engines[iid].add_request(req, prompt_tokens,
                                      prior_outputs=_prior)
        return iid

    # --- disagg handoff delivery (synchronous) -----------------------------
    def _deliver_handoff(self, src_iid: int, payload: HandoffPayload) -> None:
        """Route one exported payload to its reserved decode replica (or
        the best surviving one); with no decode capacity left, fail the
        request over to a re-prefill from the durable log."""
        rid = payload.req.rid
        self.book.on_handoff_sent(src_iid, rid, self.now)
        partial = self.book.logged_partial(rid)
        if partial is not None:      # the prefill leg's tokens are durable
            partial[:] = list(payload.outputs)
        d_iid = self.book.decode_target(rid)
        eng = self.engines.get(d_iid) if d_iid is not None else None
        if eng is None:
            d_pool = [st for st in self.book.states.values()
                      if st.role == "decode"]
            d_iid = pick_decode_target(d_pool, payload.req,
                                       self.book.block_size)
            eng = self.engines.get(d_iid) if d_iid is not None else None
        if eng is not None and eng.import_handoff(payload):
            self.book.on_handoff_delivered(rid, d_iid, payload.n_blocks,
                                           payload.wire_bytes, self.now)
        else:
            self._redispatch(payload.req)

    # --- serving loop -------------------------------------------------------
    def step_all(self) -> int:
        """One scheduling round across instances; returns tokens emitted."""
        total = 0
        for iid, eng in list(self.engines.items()):
            res = eng.step()
            # pick up completed handoff exports even on idle steps (the
            # async D2H lane can land them while the queue is empty)
            for payload in eng.take_handoffs():
                payload.src_iid = iid
                self._deliver_handoff(iid, payload)
            if res is None:
                self.book.heartbeat(iid, eng.bm.free_blocks)
                continue
            self.now = max(self.now, eng.now)
            self.book.observe_step(iid, free_blocks=eng.bm.free_blocks,
                                   est_time=res["plan"].est_time,
                                   latency=res["latency"])
            for r in res["emitted"]:
                if r.generated == 1:
                    self.book.on_first_token(iid, r.rid, self.now)
                outs = eng.outputs.get(r.rid)
                if outs is None:     # exported at handoff this very step:
                    # the payload (possibly still in the D2H lane) holds
                    # the emitted token — it must reach the durable log
                    # NOW, or a crash before delivery would lose it
                    outs = eng.handoff_outputs(r.rid)
                if outs is None:
                    continue
                partial = self.book.logged_partial(r.rid)
                if partial is not None:  # stream into the durable log
                    partial[:] = outs
            for r in res["finished"]:
                self.book.on_finished(iid, r.rid)
                self.finished.append(r)
            total += len(res["emitted"])
        return total

    def serve_until_drained(self, max_rounds: int = 5000) -> None:
        for _ in range(max_rounds):
            pending = any(e.has_work() for e in self.engines.values())
            if not pending:
                break
            self.step_all()
