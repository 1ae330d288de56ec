"""Event-driven multi-instance cluster simulation (service layer in the loop).

Supports the paper's two deployment modes:

* **PD co-location** — each instance runs prefill+decode; GoRouting picks
  one instance per request (decode pool = None).
* **PD disaggregation** — prefill instances run the local scheduler
  (SlideBatching with φ_p or a baseline); on prefill completion the request
  and its KV are pushed (xLLM layer-wise push mode — modeled as a small
  handoff delay since the push overlaps prefill) to the chosen decode
  instance, which batches all ready decodes each iteration.

Fault tolerance: instances can be killed at scheduled times; their in-flight
requests are re-dispatched by the router (prefill progress lost — KV dies
with the instance).  Instances can also be added at runtime (elastic scale).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Optional

from ..core.batching import EngineConfig
from ..core.blocks import blocks_for
from ..core.estimator import BatchLatencyEstimator
from ..core.gorouting import InstanceState, QueuedStub, decode_need_blocks
from ..core.request import Phase, Request
from .engine_sim import DecodeAllPolicy, EngineSim
from .executor import AnalyticalExecutor

ARRIVAL, STEP, KILL, SCALE_UP, HANDOFF = 0, 1, 2, 3, 4
HANDOFF_DELAY = 2e-3   # s; layer-wise KV push overlaps prefill (App. B)


@dataclass
class ClusterConfig:
    pd_mode: str = "coloc"           # "coloc" | "disagg"
    n_prefill: int = 4               # instances (coloc: all instances)
    n_decode: int = 0                # disagg only
    heartbeat_interval: float = 0.5  # b_f refresh period (s)
    heartbeat_timeout: float = 2.0   # declare dead after silence (unused in
                                     # sim — kills are explicit — kept for API)
    # per-instance prefix cache (sim model of serving/prefix_cache.py) +
    # prefix-affinity routing.  Only requests stamped with a
    # ``prefix_group`` participate, so workloads without shared prefixes
    # behave identically with this on or off.
    prefix_cache: bool = True
    cache_frac: float = 0.25         # cap: fraction of device blocks
    # tiered KV (sim mirror of serving/kv_pool.KVTierStore): a host-tier
    # budget in blocks.  Evicted request KV beyond it demotes to the int8
    # cold tier (BlockManager.host_budget_blocks), and the prefix cache
    # spills evicted entries into the same-size host tier instead of
    # destroying them (SimPrefixCache spill model).  None = legacy
    # unbounded host mirrors + destroy-on-evict cache.
    host_tier_blocks: Optional[int] = None
    # heterogeneous clusters: per-tier device-block budgets overriding
    # executor.num_blocks (disagg decode replicas often carry more KV
    # memory than prefill replicas).  None = homogeneous.
    prefill_blocks: Optional[int] = None
    decode_blocks: Optional[int] = None
    # bytes per KV block on the handoff wire (live fp32 handoffs move
    # exactly blocks x block_bytes, so setting this to the serving pool's
    # per-block nbytes makes ClusterSim.handoff_bytes match RouterBook's
    # live counter).  0 = don't account bytes.
    handoff_block_bytes: int = 0


class ClusterSim:
    def __init__(self, make_policy_fn, router, executor: AnalyticalExecutor,
                 est: BatchLatencyEstimator, eng_cfg: EngineConfig,
                 cluster_cfg: ClusterConfig, bm_kwargs: Optional[dict] = None):
        self.make_policy_fn = make_policy_fn
        self.router = router
        self.executor = executor
        self.est = est
        self.eng_cfg = eng_cfg
        self.ccfg = cluster_cfg
        self.bm_kwargs = bm_kwargs or {}
        self._iid = itertools.count()
        self.engines: dict[int, EngineSim] = {}
        self.states: dict[int, InstanceState] = {}
        self.decode_engines: dict[int, EngineSim] = {}
        self.decode_states: dict[int, InstanceState] = {}
        self.decode_target: dict[int, int] = {}   # rid -> decode iid (disagg)
        # disagg two-leg accounting, mirroring serving/dispatch.RouterBook:
        # rid -> (decode iid, blocks reserved there at admission)
        self.reservations: dict[int, tuple[int, int]] = {}
        self.reservation_hits = 0
        self.reservation_misses = 0
        self.reserved_blocks_total = 0
        self.adopted_blocks_total = 0
        self.handoffs = 0
        self.handoff_blocks = 0
        self.handoff_bytes = 0
        self.finished: list[Request] = []
        self.dropped: list[Request] = []
        # streaming mode (run_stream): finished requests are handed to this
        # callback instead of accumulating in self.finished
        self.on_finished = None
        for _ in range(cluster_cfg.n_prefill):
            self._new_instance(prefill=True)
        for _ in range(cluster_cfg.n_decode):
            self._new_instance(prefill=False)

    # ------------------------------------------------------------------
    # speculative-decoding counters, aggregated over both tiers so
    # sim.metrics.spec_counters works on a ClusterSim exactly like it
    # does on a single EngineSim or the live EngineStats.
    def _all_engines(self):
        yield from self.engines.values()
        yield from self.decode_engines.values()

    @property
    def spec_proposed(self) -> int:
        return sum(e.spec_proposed for e in self._all_engines())

    @property
    def spec_accepted(self) -> int:
        return sum(e.spec_accepted for e in self._all_engines())

    @property
    def spec_rejected(self) -> int:
        return sum(e.spec_rejected for e in self._all_engines())

    @property
    def spec_depth_hist(self) -> dict:
        hist: dict[int, int] = {}
        for e in self._all_engines():
            for d, n in e.spec_depth_hist.items():
                hist[d] = hist.get(d, 0) + n
        return hist

    # ------------------------------------------------------------------
    def _new_instance(self, prefill: bool) -> int:
        iid = next(self._iid)
        from ..core.blocks import BlockManager
        bmk = dict(self.bm_kwargs)
        if self.ccfg.host_tier_blocks is not None:
            bmk.setdefault("host_budget_blocks", self.ccfg.host_tier_blocks)
        # heterogeneous tiers: each side may override the executor's budget
        n_blocks = self.executor.num_blocks
        if prefill and self.ccfg.prefill_blocks is not None:
            n_blocks = self.ccfg.prefill_blocks
        elif not prefill and self.ccfg.decode_blocks is not None:
            n_blocks = self.ccfg.decode_blocks
        bm = BlockManager(n_blocks, self.executor.block_size,
                          self.executor.t_block, beta=self.eng_cfg.beta,
                          **bmk)
        if prefill:
            cfg = self.eng_cfg
            role = "coloc"
            if self.ccfg.pd_mode == "disagg":
                from dataclasses import replace
                cfg = replace(cfg, pd_mode="prefill")
                role = "prefill"
            cache = None
            if self.ccfg.prefix_cache:
                from ..core.prefix import SimPrefixCache
                cache = SimPrefixCache(
                    self.executor.block_size,
                    max(1, int(n_blocks * self.ccfg.cache_frac)),
                    spill=self.ccfg.host_tier_blocks is not None,
                    host_budget_blocks=self.ccfg.host_tier_blocks)
            eng = EngineSim(iid, self.make_policy_fn(), self.executor,
                            self.est, cfg, bm, prefix_cache=cache)
            self.engines[iid] = eng
            self.states[iid] = InstanceState(
                iid=iid, b_f=bm.num_device_blocks,
                total_blocks=bm.num_device_blocks, role=role)
        else:
            eng = EngineSim(iid, DecodeAllPolicy(), self.executor,
                            self.est, self.eng_cfg, bm)
            self.decode_engines[iid] = eng
            self.decode_states[iid] = InstanceState(
                iid=iid, b_f=bm.num_device_blocks,
                total_blocks=bm.num_device_blocks, role="decode")
        return iid

    # ------------------------------------------------------------------
    def run(self, requests: list[Request], *, until: Optional[float] = None,
            kills: Optional[list[tuple[float, int]]] = None,
            scale_ups: Optional[list[float]] = None) -> list[Request]:
        """Simulate serving ``requests``; returns all requests (terminated)."""
        seq = itertools.count()
        heap: list[tuple[float, int, int, object]] = []
        for r in sorted(requests, key=lambda r: r.arrival):
            heapq.heappush(heap, (r.arrival, next(seq), ARRIVAL, r))
        for t, iid in (kills or []):
            heapq.heappush(heap, (t, next(seq), KILL, iid))
        for t in (scale_ups or []):
            heapq.heappush(heap, (t, next(seq), SCALE_UP, None))
        last_hb = 0.0

        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            if until is not None and now > until:
                break
            # periodic b_f heartbeat (§4.4 monitoring)
            if now - last_hb >= self.ccfg.heartbeat_interval:
                self._heartbeat(now)
                last_hb = now

            if kind == ARRIVAL:
                self._dispatch(payload, now, heap, seq)
            elif kind == STEP:
                self._step(payload, now, heap, seq)
            elif kind == HANDOFF:
                req, d_iid, tokens = payload
                self._arrive_decode(req, d_iid, tokens, now, heap, seq)
            elif kind == KILL:
                self._kill(payload, now, heap, seq)
            elif kind == SCALE_UP:
                iid = self._new_instance(prefill=True)
                if self.ccfg.pd_mode == "disagg":
                    pass  # scale the prefill tier; decode tier static here
        return requests

    # ------------------------------------------------------------------
    def run_stream(self, request_iter, *, until: Optional[float] = None,
                   on_finished=None) -> int:
        """``run`` with O(1)-memory arrivals: requests are pulled lazily
        from ``request_iter`` (MUST be sorted by arrival) and finished
        requests are handed to ``on_finished`` instead of accumulating —
        the 10⁵⁺-request replay entry point.

        Event ordering is identical to ``run``: there, every arrival gets
        a lower heap sequence number than any derived event, so an arrival
        wins any timestamp tie — here the pending arrival is taken while
        ``arrival <= heap[0] time``.  Kills/scale-ups are not supported in
        streaming mode.  Returns the number of requests submitted.
        """
        seq = itertools.count()
        heap: list[tuple[float, int, int, object]] = []
        self.on_finished = on_finished
        it = iter(request_iter)
        nxt = next(it, None)
        n_seen = 0
        last_hb = 0.0
        try:
            while nxt is not None or heap:
                if nxt is not None and (not heap
                                        or nxt.arrival <= heap[0][0]):
                    now, kind, payload = nxt.arrival, ARRIVAL, nxt
                    nxt = next(it, None)
                else:
                    now, _, kind, payload = heapq.heappop(heap)
                if until is not None and now > until:
                    break
                if now - last_hb >= self.ccfg.heartbeat_interval:
                    self._heartbeat(now)
                    last_hb = now
                if kind == ARRIVAL:
                    n_seen += 1
                    self._dispatch(payload, now, heap, seq)
                elif kind == STEP:
                    self._step(payload, now, heap, seq)
                elif kind == HANDOFF:
                    req, d_iid, tokens = payload
                    self._arrive_decode(req, d_iid, tokens, now, heap, seq)
        finally:
            self.on_finished = None
        return n_seen

    # ------------------------------------------------------------------
    def _heartbeat(self, now: float) -> None:
        for iid, eng in self.engines.items():
            self.states[iid].b_f = eng.bm.free_blocks
        for iid, eng in self.decode_engines.items():
            self.decode_states[iid].b_f = eng.bm.free_blocks

    def _release_reservation(self, rid: int) -> None:
        """Void rid's decode reservation (finish/failure/re-dispatch)."""
        res = self.reservations.pop(rid, None)
        if res is None:
            return
        d_iid, need = res
        st = self.decode_states.get(d_iid)
        if st is not None:
            st.unreserve(need)

    def _dispatch(self, req: Request, now: float, heap, seq) -> None:
        p_iid = self._route(req, now)
        if p_iid is None:
            return
        eng = self.engines[p_iid]
        if eng.idle:
            heapq.heappush(heap, (max(now, eng.busy_until), next(seq),
                                  STEP, p_iid))

    def _route(self, req: Request, now: float) -> Optional[int]:
        """Router half of arrival handling: select an instance, update its
        frontend view, reserve decode capacity, enqueue on the engine.
        Returns the chosen prefill iid (None = dropped); the caller owns
        scheduling the engine wake-up, so the windowed loop can reuse
        this without a global heap."""
        # a re-dispatch supersedes any reservation the prior leg held
        self._release_reservation(req.rid)
        pools = list(self.states.values())
        dpool = (list(self.decode_states.values())
                 if self.ccfg.pd_mode == "disagg" else None)
        exec_est = self.est.prefill_time(req.prompt_len)
        # prefix affinity: cached tokens usable by this request, per replica
        affinity = None
        if self.ccfg.prefix_cache and req.prefix_group >= 0:
            affinity = {iid: eng.prefix_cache.peek_tokens(req)
                        for iid, eng in self.engines.items()
                        if eng.prefix_cache is not None} or None
        p_iid, d_iid = self.router.select(
            req, pools, dpool, now,
            block_size=self.executor.block_size, exec_est=exec_est,
            affinity=affinity)
        if p_iid is None:
            self.dropped.append(req)
            return None
        if affinity and affinity.get(p_iid):
            exec_est = self.est.prefill_time_cached(
                req.prompt_len, affinity[p_iid])
        st = self.states[p_iid]
        st.on_dispatch(QueuedStub(req.rid, now, req.priority, req.weight,
                                  req.prompt_len,
                                  req.arrival + req.slo.ttft, exec_est), now)
        if d_iid is not None:
            self.decode_target[req.rid] = d_iid
            # reserve the handoff blocks on the decode target at admission
            # (RouterBook.route parity): never oversubscribe — an
            # unfittable reservation is recorded as a zero-block miss.
            st_d = self.decode_states[d_iid]
            need = decode_need_blocks(req, self.executor.block_size)
            if st_d.reserved_blocks + need > st_d.total_blocks:
                need = 0
            st_d.reserve(need)
            self.reserved_blocks_total += need
            self.reservations[req.rid] = (d_iid, need)
        eng = self.engines[p_iid]
        eng.add_request(req, now)
        return p_iid

    def _engine(self, iid: int) -> Optional[EngineSim]:
        return self.engines.get(iid) or self.decode_engines.get(iid)

    def _step(self, iid: int, now: float, heap, seq) -> None:
        eng = self._engine(iid)
        if eng is None or not eng.alive or now < eng.busy_until:
            return
        res = eng.step(now)
        if res is None:
            return
        self._on_step_result(iid, eng, res, heap, seq)
        heapq.heappush(heap, (res.end, next(seq), STEP, iid))

    def _on_step_result(self, iid: int, eng: EngineSim, res, heap,
                        seq) -> None:
        """Apply one step's outcomes to the frontend view: prefill-done /
        finished notifications, disagg handoffs, reservation release.
        Shared by the reference loop and the windowed loop (which passes
        ``heap=None`` — coloc only, so the disagg branch never fires)."""
        is_prefill_tier = iid in self.engines
        st = (self.states if is_prefill_tier else self.decode_states)[iid]
        for r in res.prefill_done:
            if self.ccfg.pd_mode == "disagg" and is_prefill_tier \
                    and r.phase != Phase.FINISHED:
                # the request leaves at handoff: clear the prefill stub
                # but leave n_d to the decode replica (live parity)
                st.on_prefill_exported(r.rid, res.end)
                self._handoff(r, eng, res.end, heap, seq)
            else:
                st.on_prefill_done(r.rid, res.end)
        for r in res.finished:
            st.on_finished(r.rid)
            self._release_reservation(r.rid)
            if self.on_finished is not None:
                self.on_finished(r)
            else:
                self.finished.append(r)

    def _handoff(self, req: Request, p_eng: EngineSim, now: float,
                 heap, seq) -> None:
        """Prefill finished at ``now``: release prefill-side KV and schedule
        the decode-side arrival after the (mostly overlapped) push delay.
        Importing must NOT happen before ``t_arrive`` or the decode tier
        could emit token 2 before token 1's timestamp."""
        d_iid = self.decode_target.get(req.rid)
        if d_iid is None or d_iid not in self.decode_engines \
                or not self.decode_states[d_iid].alive:
            self._release_reservation(req.rid)
            alive = [s for s in self.decode_states.values() if s.alive]
            if not alive:
                self.dropped.append(req)
                return
            d_iid = max(alive, key=lambda s: s.effective_free).iid
        tokens = p_eng.export_request(req)
        heapq.heappush(heap, (now + HANDOFF_DELAY, next(seq), HANDOFF,
                              (req, d_iid, tokens)))

    def _arrive_decode(self, req: Request, d_iid: int, tokens: int,
                       now: float, heap, seq) -> None:
        d_eng = self.decode_engines.get(d_iid)
        if d_eng is None or not d_eng.alive:
            self._release_reservation(req.rid)
            self.dropped.append(req)
            return
        d_eng.import_request(req, tokens, now)
        # settle the admission-time reservation: a hit iff the payload
        # landed on the reserved target with the promised block count
        # (on_handoff_delivered parity)
        nb = blocks_for(tokens, self.executor.block_size)
        res = self.reservations.pop(req.rid, None)
        if res is not None:
            r_iid, need = res
            st_r = self.decode_states.get(r_iid)
            if st_r is not None:
                st_r.unreserve(need)
            if r_iid == d_iid and need == nb:
                self.reservation_hits += 1
            else:
                self.reservation_misses += 1
        else:
            self.reservation_misses += 1
        self.adopted_blocks_total += nb
        self.handoffs += 1
        self.handoff_blocks += nb
        self.handoff_bytes += nb * self.ccfg.handoff_block_bytes
        self.decode_states[d_iid].n_d += 1
        if d_eng.idle:
            heapq.heappush(heap, (max(now, d_eng.busy_until),
                                  next(seq), STEP, d_iid))

    def _kill(self, iid: int, now: float, heap, seq) -> None:
        eng = self._engine(iid)
        if eng is None:
            return
        orphans = eng.kill()
        if iid in self.states:
            self.states[iid].alive = False
        if iid in self.decode_states:
            self.decode_states[iid].alive = False
            # reservations on a dead decode replica are void (the state
            # is dead, so no unreserve — mirrors RouterBook.drop_instance)
            for rid, (d_iid, _) in list(self.reservations.items()):
                if d_iid == iid:
                    self.reservations.pop(rid, None)
        # failure recovery: re-dispatch from the request log (KV lost)
        for r in orphans:
            self._dispatch(r, now, heap, seq)
