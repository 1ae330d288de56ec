"""Router-side bookkeeping shared by the synchronous ``ServiceController``
and the asynchronous ``ServiceFrontend`` (port of
``repro.serving.dispatch``).

One ``RouterBook`` owns everything GoRouting needs to see about a fleet of
engine replicas: per-instance :class:`InstanceState` (prefill queue mirror,
decode counts, free blocks, EWMA speed), the durable request log used for
failure recovery, the prefix-affinity registry (which replica has recently
prefilled which prompt prefix — so repeated prefixes land on the replica
whose radix cache already holds their KV), and the dispatch step itself
(router ``select`` + state mutation + logging).  Neither caller touches
``InstanceState`` directly — the frontend serialises access with a lock,
the controller runs single threaded.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.estimator import BatchLatencyEstimator
from ..core.gorouting import InstanceState, QueuedStub, decode_need_blocks
from ..core.prefix import PrefixRegistry, chunk_hashes, usable_prefix
from ..core.request import Request


class RouterBook:
    def __init__(self, router, est: BatchLatencyEstimator,
                 speed_ewma: float = 0.2, *, prefix_affinity: bool = True,
                 block_size: int = 16):
        self.router = router
        self.est = est
        self.speed_ewma = speed_ewma
        self.block_size = block_size
        self.states: dict[int, InstanceState] = {}
        self.registry: Optional[PrefixRegistry] = (
            PrefixRegistry(block_size) if prefix_affinity else None)
        # durable request log: request + prompt + tokens streamed so far —
        # failover resumes generation exactly where the dead replica stopped.
        self.request_log: dict[int, tuple[Request, np.ndarray, list]] = {}
        # disagg two-leg lifecycle: rid -> (decode target iid, blocks
        # reserved there at admission); released at adoption/failure
        self.reservations: dict[int, tuple[int, int]] = {}
        # fleet-wide disagg counters (mirrored by ClusterSim for parity)
        self.reservation_hits = 0    # adoption landed on the reserved
        self.reservation_misses = 0  # target with the promised blocks
        self.reserved_blocks_total = 0
        self.adopted_blocks_total = 0
        self.handoffs = 0
        self.handoff_blocks = 0
        self.handoff_bytes = 0

    # --- instance lifecycle -------------------------------------------
    def add_instance(self, iid: int, total_blocks: int,
                     free_blocks: int, *,
                     has_prefix_cache: bool = True,
                     role: str = "coloc") -> InstanceState:
        st = InstanceState(iid=iid, b_f=free_blocks,
                           total_blocks=total_blocks, role=role)
        self.states[iid] = st
        if not has_prefix_cache:
            # a cache-less replica joined: affinity claims (cache-discounted
            # stub costs, prefix-holder tiebreaks) would be false for it, so
            # turn prefix-affinity routing off for the whole fleet
            self.registry = None
        return st

    def drop_instance(self, iid: int) -> None:
        st = self.states.pop(iid, None)
        if st is not None:
            st.alive = False
        if self.registry is not None:
            self.registry.drop(iid)
        # reservations on a dead decode replica are void; requests mid-
        # handoff to it are re-dispatched by the frontend's failover
        for rid, (d_iid, _) in list(self.reservations.items()):
            if d_iid == iid:
                self.reservations.pop(rid, None)

    # --- request log ---------------------------------------------------
    def log_request(self, req: Request, prompt_tokens) -> None:
        self.request_log[req.rid] = (req, np.asarray(prompt_tokens), [])

    def logged_partial(self, rid: int) -> Optional[list]:
        logged = self.request_log.get(rid)
        return None if logged is None else logged[2]

    def forget(self, rid: int) -> None:
        self.request_log.pop(rid, None)

    # --- dispatch ------------------------------------------------------
    def route(self, req: Request, now: float,
              exec_est: Optional[float] = None,
              prompt_tokens=None) -> Optional[int]:
        """Pick an instance via the router and record the dispatch.

        Role-aware (disagg): the prefill pool is coloc + prefill replicas
        and the decode pool is the decode replicas — the router picks a
        prefill target AND a decode target, whose blocks for the eventual
        KV handoff are reserved here, at admission.  With no live decode
        replica the prefill-role replicas are excluded too (a request
        must be able to finish where it prefills), which is exactly the
        churn-failover path: re-dispatch lands on a coloc replica.
        """
        # a re-dispatch supersedes any reservation the prior leg held
        self.release_reservation(req.rid)
        pools = list(self.states.values())
        decode_pool = [st for st in pools if st.role == "decode"]
        live_decode = [d for d in decode_pool if d.alive]
        if live_decode:
            prefill_pool = [st for st in pools
                            if st.role in ("coloc", "prefill")]
        else:
            prefill_pool = [st for st in pools if st.role == "coloc"]
        if exec_est is None:
            exec_est = self.est.prefill_time(req.prompt_len)
        affinity, chain = None, None
        if self.registry is not None and prompt_tokens is not None:
            # hash the prompt once; lookup and observe both consume it
            chain = chunk_hashes(prompt_tokens, self.registry.block_size)
            affinity = self.registry.lookup(prompt_tokens,
                                            chain=chain) or None
        iid, d_iid = self.router.select(
            req, prefill_pool, decode_pool if live_decode else None, now,
            block_size=self.block_size, exec_est=exec_est,
            affinity=affinity)
        if iid is None:
            return None
        if d_iid is not None and self.states[iid].role == "prefill":
            # reserve the handoff blocks on the decode target now, so
            # concurrent admissions see them as spoken for.  Never
            # oversubscribe: an unfittable reservation is recorded as a
            # zero-block miss (the adoption-time eviction path covers it).
            st_d = self.states[d_iid]
            need = decode_need_blocks(req, self.block_size)
            if st_d.reserved_blocks + need > st_d.total_blocks:
                need = 0
            st_d.reserve(need)
            self.reserved_blocks_total += need
            self.reservations[req.rid] = (d_iid, need)
        # the stub mirrors what the replica will actually compute: after a
        # prefix-cache hit, only the uncached suffix
        stub_exec = exec_est
        if affinity and affinity.get(iid):
            cached = usable_prefix(affinity[iid], req.prompt_len,
                                   self.registry.block_size)
            stub_exec = self.est.prefill_time_cached(req.prompt_len, cached)
        self.states[iid].on_dispatch(
            QueuedStub(req.rid, now, req.priority, req.weight,
                       req.prompt_len, req.arrival + req.slo.ttft,
                       stub_exec), now)
        if self.registry is not None and chain is not None:
            self.registry.observe(iid, prompt_tokens, chain=chain)
        return iid

    # --- event-driven state updates (§4.4 monitoring) ------------------
    def heartbeat(self, iid: int, free_blocks: int) -> None:
        """Periodic b_f refresh with no latency observation."""
        st = self.states.get(iid)
        if st is not None:
            st.b_f = free_blocks

    def observe_step(self, iid: int, *, free_blocks: int, est_time: float,
                     latency: float) -> None:
        st = self.states.get(iid)
        if st is None:
            return
        st.b_f = free_blocks
        # straggler EWMA: observed vs estimated batch latency
        ratio = max(est_time, 1e-9) / max(latency, 1e-9)
        st.speed = ((1 - self.speed_ewma) * st.speed
                    + self.speed_ewma * min(max(ratio, 0.05), 2.0))

    def on_first_token(self, iid: int, rid: int, now: float) -> None:
        st = self.states.get(iid)
        if st is None:
            return
        if st.role == "prefill":
            # the request leaves at handoff: clear the prefill stub but
            # leave n_d alone — the decode replica's n_d is bumped when
            # the payload is adopted (on_handoff_delivered)
            st.on_prefill_exported(rid, now)
        else:
            st.on_prefill_done(rid, now)

    def on_finished(self, iid: int, rid: int) -> None:
        st = self.states.get(iid)
        if st is not None:
            st.on_finished(rid)
        self.release_reservation(rid)
        self.forget(rid)

    # --- disagg handoff lifecycle --------------------------------------
    def decode_target(self, rid: int) -> Optional[int]:
        """Decode replica reserved for rid at admission (None if the
        reservation is gone — e.g. the target died)."""
        res = self.reservations.get(rid)
        return None if res is None else res[0]

    def on_handoff_sent(self, src_iid: int, rid: int, now: float) -> None:
        """Prefill replica exported rid's KV (covers failover recomputes,
        which emit no first token on the prefill leg)."""
        st = self.states.get(src_iid)
        if st is not None:
            st.on_prefill_exported(rid, now)

    def on_handoff_delivered(self, rid: int, iid: int, n_blocks: int,
                             wire_bytes: int, now: float) -> None:
        """A decode replica adopted rid's payload: settle the reservation
        (hit iff it landed on the reserved target with the promised
        blocks) and start the decode leg there."""
        res = self.reservations.pop(rid, None)
        if res is not None:
            d_iid, need = res
            st_r = self.states.get(d_iid)
            if st_r is not None:
                st_r.unreserve(need)
            if d_iid == iid and need == n_blocks:
                self.reservation_hits += 1
            else:
                self.reservation_misses += 1
        else:
            self.reservation_misses += 1
        self.adopted_blocks_total += n_blocks
        st = self.states.get(iid)
        if st is not None:
            st.n_d += 1
            st.ts = now
        self.handoffs += 1
        self.handoff_blocks += n_blocks
        self.handoff_bytes += wire_bytes

    def release_reservation(self, rid: int) -> None:
        """Void rid's decode reservation (finish/failure/re-dispatch)."""
        res = self.reservations.pop(rid, None)
        if res is None:
            return
        d_iid, need = res
        st = self.states.get(d_iid)
        if st is not None:
            st.unreserve(need)
