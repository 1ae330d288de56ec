"""GoRouting (§4.4, Alg. 2): gain-oriented, capability-aware global router.

The router keeps lightweight per-instance state (event-driven prefill queue
``Q_pre`` + decode counter ``n_d``, periodically refreshed free blocks
``b_f``) with timestamp staleness compensation, and dispatches each request
to maximize *incremental gain* while reserving capacity on lightly loaded
instances for future long / high-priority requests (the anti-over-balancing
dual-threshold rule of Fig. 10).

Baselines: Min-Load and Round-Robin.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

from .estimator import BatchLatencyEstimator
from .prefix import usable_prefix
from .request import Request


# replica-originated events a frontend can learn about late (window
# boundaries / heartbeats) — see InstanceState.apply_event
EV_PREFILL_DONE, EV_FINISHED = 0, 1


@dataclass
class QueuedStub:
    """Router-side view of one in-flight prefill request."""
    rid: int
    arrival: float
    priority: int
    weight: float
    prompt_len: int
    ttft_deadline: float         # absolute
    exec: float                  # estimated remaining prefill time


@dataclass
class InstanceState:
    """Router-side state for one engine instance (§4.4 monitoring)."""
    iid: int
    pre_queue: dict[int, QueuedStub] = field(default_factory=dict)
    n_d: int = 0                  # ongoing decode requests
    b_f: int = 0                  # free KV blocks (periodic report)
    total_blocks: int = 1
    prefill_len_total: int = 0    # L_pre for Eq. (11)
    ts: float = 0.0               # timestamp of last queue mutation
    speed: float = 1.0            # EWMA throughput factor (straggler aware)
    alive: bool = True
    role: str = "coloc"           # "coloc" | "prefill" | "decode"
    # decode-capacity blocks promised to in-flight prefill legs (disagg):
    # counted against b_f when picking a decode target so concurrent
    # admissions cannot oversubscribe a replica's block budget
    reserved_blocks: int = 0

    @property
    def effective_free(self) -> int:
        """Reported free blocks net of outstanding reservations."""
        return self.b_f - self.reserved_blocks

    def reserve(self, n: int) -> None:
        self.reserved_blocks += n

    def unreserve(self, n: int) -> None:
        self.reserved_blocks = max(0, self.reserved_blocks - n)

    # --- event-driven updates -----------------------------------------
    def on_dispatch(self, stub: QueuedStub, now: float) -> None:
        if not self.pre_queue:
            self.ts = now
        self.pre_queue[stub.rid] = stub
        self.prefill_len_total += stub.prompt_len

    def on_prefill_done(self, rid: int, now: float) -> None:
        stub = self.pre_queue.pop(rid, None)
        if stub is not None:
            self.prefill_len_total -= stub.prompt_len
            self.n_d += 1
        self.ts = now

    def on_prefill_exported(self, rid: int, now: float) -> None:
        """Prefill-role variant of ``on_prefill_done``: the request leaves
        this replica at handoff, so the decode counter stays untouched
        (the decode replica's ``n_d`` is bumped at adoption instead)."""
        stub = self.pre_queue.pop(rid, None)
        if stub is not None:
            self.prefill_len_total -= stub.prompt_len
        self.ts = now

    def on_finished(self, rid: int) -> None:
        stub = self.pre_queue.pop(rid, None)
        if stub is not None:
            # finished without ever reporting prefill-done here (e.g. a
            # failover-resumed request whose first token predates this
            # instance): clear the stub; n_d was never incremented.
            self.prefill_len_total -= stub.prompt_len
            return
        self.n_d = max(0, self.n_d - 1)

    def apply_event(self, kind: int, rid: int, t: float) -> None:
        """Apply one replica-originated event delivered late — the
        stale-view update path.  The live frontend and the sharded
        replay both learn about replica progress in delayed batches
        (heartbeats / window-boundary ack columns), not at the instant
        it happens; ``t`` is the ORIGINAL event time, so the ``ts``
        staleness compensation in ``queue_exec_total`` keeps measuring
        real elapsed progress, not transport lag."""
        if kind == EV_PREFILL_DONE:
            self.on_prefill_done(rid, t)
        elif kind == EV_FINISHED:
            self.on_finished(rid)
        else:                                           # pragma: no cover
            raise ValueError(f"unknown replica event kind {kind}")

    def queue_exec_total(self, now: float) -> float:
        """Σ exec over Q_pre with staleness compensation: subtract elapsed
        time since the last mutation (prefill progress the events missed)."""
        tot = sum(s.exec for s in self.pre_queue.values())
        if self.pre_queue:
            tot = max(0.0, tot - max(0.0, now - self.ts))
        return tot / max(self.speed, 1e-6)


def decode_need_blocks(req: Request, block_size: int) -> int:
    """Device blocks a decode replica must hold to adopt this request's
    KV at handoff — sized from the handoff extent ``needed_context`` ==
    prompt_len + max(0, generated-1) (exact for fresh admissions AND
    failover re-admissions; never reads the output-length oracle)."""
    ctx = req.prompt_len + max(0, req.generated - 1)
    return -(-ctx // block_size)


def pick_decode_target(decode_pool: list[InstanceState], req: Request,
                       block_size: int) -> Optional[int]:
    """Alg. 2 line 19, reservation-aware: prefer the decode replica with
    the most free blocks NET of outstanding reservations, among those
    that can actually hold the handoff KV; fall back to max effective
    free when none fits (admission control rejects upstream)."""
    d_live = [d for d in decode_pool if d.alive]
    if not d_live:
        return None
    need = decode_need_blocks(req, block_size)
    fits = [d for d in d_live if d.effective_free >= need]
    return max(fits or d_live, key=lambda d: d.effective_free).iid


@dataclass
class RouterConfig:
    alpha: float = 0.7            # candidate-set slack  C={Δ_p >= α·Δ_max}
    mu: float = 0.25              # light-load threshold (× TTFT_SLO)
    lam: float = 0.8              # heavy-load threshold (× TTFT_SLO)
    pd_mode: str = "coloc"        # "coloc" | "disagg"
    tpot_guard: float = 0.8       # coloc: exclude instance if t̂_d nears TPOT
    hedge_high_priority: bool = False   # straggler mitigation (beyond-paper)
    # weight on prefill work saved by a prefix-cache hit when comparing
    # instance load.  > 1 because a hit's savings recur: the prefix stays
    # warm for future repeats and shared blocks spare pool pressure, so
    # strict completion-time greedy (== 1) under-values affinity.
    affinity_bonus: float = 2.0


class GoRouting:
    name = "gorouting"

    def __init__(self, est: BatchLatencyEstimator, cfg: RouterConfig,
                 sort_key: Optional[Callable] = None):
        self.est = est
        self.cfg = cfg
        # mirror of the local scheduler's queue ordering; default: EDF-ish
        self.sort_key = sort_key or (lambda s, now: s.ttft_deadline)

    # ------------------------------------------------------------------
    def _decode_overhead(self, inst: InstanceState, block_size: int) -> float:
        """t̂_d(n_d), Eq. (10)–(11): estimated decode time riding along each
        co-located batch, from the block-occupancy estimate of decode KV."""
        if self.cfg.pd_mode != "coloc" or inst.n_d == 0:
            return 0.0
        used = inst.total_blocks - inst.b_f
        l_kv_d = max(0, used - inst.prefill_len_total // block_size) * block_size
        return self.est.a_d * l_kv_d + self.est.b_d * inst.n_d

    def _exec_schedule(self, inst: InstanceState, now: float,
                       extra: Optional[QueuedStub], block_size: int,
                       ) -> tuple[float, dict[int, float]]:
        """EstimateExec for every queued request on ``inst`` (+``extra``).

        Returns (total drain time, {rid: completion offset}).  Uses the
        conservative φ-style scaling with t_budget = min TPOT_SLO (App. A)
        plus the coloc decode term per batch round.
        """
        stubs = list(inst.pre_queue.values())
        if extra is not None:
            stubs = stubs + [extra]
        stubs.sort(key=lambda s: self.sort_key(s, now))
        t_c = self.est.t_c
        dec = self._decode_overhead(inst, block_size)
        # φ-scaling: each unit of prefill work inflates by budget/(budget-t_c)
        # — approximated by adding (t_c + decode term) per round where a
        # round carries ~t_budget of prefill work.
        acc = 0.0
        stale = max(0.0, now - inst.ts) if inst.pre_queue else 0.0
        out: dict[int, float] = {}
        for s in stubs:
            acc += s.exec / max(inst.speed, 1e-6) + t_c + dec
            out[s.rid] = acc
        total = max(0.0, acc - stale)
        for k in out:
            out[k] = max(0.0, out[k] - stale)
        return total, out

    def _gain(self, inst: InstanceState, now: float,
              extra: Optional[QueuedStub], block_size: int) -> float:
        """EstimateGain (App. A): Σ w_r(1)·1[exec ≤ remaining TTFT budget]."""
        _, completion = self._exec_schedule(inst, now, extra, block_size)
        stubs = {s.rid: s for s in inst.pre_queue.values()}
        if extra is not None:
            stubs[extra.rid] = extra
        g = 0.0
        for rid, done in completion.items():
            s = stubs[rid]
            if now + done <= s.ttft_deadline:
                g += s.weight
        return g

    # ------------------------------------------------------------------
    def select(self, req: Request, prefill_pool: list[InstanceState],
               decode_pool: Optional[list[InstanceState]], now: float,
               block_size: int = 16, exec_est: Optional[float] = None,
               affinity: Optional[dict[int, int]] = None,
               ) -> tuple[Optional[int], Optional[int]]:
        """Alg. 2: returns (prefill_instance, decode_instance) ids.

        ``affinity``: optional {iid: cached prefix tokens} from the prefix
        registry/caches — an instance already holding the request's prefix
        prefills only the uncached suffix, so its per-instance exec
        estimate (and hence its incremental gain) improves, and ties in
        the reservation rule break toward the prefix holder.
        """
        live = [p for p in prefill_pool if p.alive]
        if not live:
            return None, None
        if exec_est is None:
            exec_est = self.est.prefill_time(req.prompt_len)

        def exec_for(iid: int) -> float:
            cached = (affinity or {}).get(iid, 0)
            if cached <= 0:
                return exec_est
            cached = usable_prefix(cached, req.prompt_len, block_size)
            return self.est.prefill_time_cached(req.prompt_len, cached)

        def stub_for(iid: int) -> QueuedStub:
            return QueuedStub(req.rid, now, req.priority, req.weight,
                              req.prompt_len, req.arrival + req.slo.ttft,
                              exec_for(iid))

        # prefill work saved by landing on each instance's cached prefix,
        # weighted by the recurrence bonus (see RouterConfig.affinity_bonus)
        save = {p.iid: self.cfg.affinity_bonus
                * max(0.0, exec_est - exec_for(p.iid)) for p in live}

        # lines 2-6: incremental gain per instance
        deltas: dict[int, float] = {}
        for p in live:
            pre = self._gain(p, now, None, block_size)
            post = self._gain(p, now, stub_for(p.iid), block_size)
            deltas[p.iid] = post - pre
        d_max = max(deltas.values())

        # coloc decode-latency guard: drop instances whose decode term would
        # blow the TPOT SLO once the queued prefills also enter decode.
        def tpot_ok(p: InstanceState) -> bool:
            if self.cfg.pd_mode != "coloc":
                return True
            t_d = self.est.a_d * 0 + self.est.b_d * (p.n_d + len(p.pre_queue))
            return t_d + self._decode_overhead(p, block_size) \
                <= self.cfg.tpot_guard * req.slo.tpot

        # line 7: candidate set
        cand = [p for p in live
                if deltas[p.iid] >= self.cfg.alpha * d_max and tpot_ok(p)]
        if not cand:
            cand = live

        exec_wo = {p.iid: self._exec_schedule(p, now, None, block_size)[0]
                   for p in cand}
        exec_w = {p.iid: self._exec_schedule(p, now, stub_for(p.iid),
                                             block_size)[0]
                  for p in cand}

        if d_max > 0:
            ttft = req.slo.ttft
            light = [p for p in cand if exec_wo[p.iid] < self.cfg.mu * ttft]
            heavy = [p for p in cand if exec_w[p.iid] > self.cfg.lam * ttft]
            heavy_ids = {p.iid for p in heavy}
            non_heavy = [p for p in cand if p.iid not in heavy_ids]
            # prefix-affinity, reservation-aware: compare light instances on
            # load NET of the prefill work a cached prefix saves, so a
            # slightly busier prefix holder still wins; elsewhere affinity
            # only breaks ties (the anti-over-balancing rule keeps priority).
            if light:                                  # most idle light one
                pick = min(light,
                           key=lambda p: (exec_wo[p.iid] - save[p.iid],
                                          exec_wo[p.iid]))
            elif non_heavy:                            # HEAVIEST non-heavy:
                pick = max(non_heavy,                  # reserve light capacity
                           key=lambda p: (exec_wo[p.iid], save[p.iid]))
            else:                                      # all heavy: balance
                pick = min(cand,
                           key=lambda p: (exec_wo[p.iid] - save[p.iid],
                                          exec_wo[p.iid]))
        else:
            # line 18 fallback: no instance can meet the SLO — min load
            pick = min(live, key=lambda p: self._exec_schedule(
                p, now, None, block_size)[0] - save.get(p.iid, 0.0))

        d_pick = None
        if decode_pool is not None:
            d_pick = pick_decode_target(decode_pool, req, block_size)
        return pick.iid, d_pick


# --------------------------------------------------------------------------
# global-scheduler baselines
# --------------------------------------------------------------------------

class MinLoad:
    """Dispatch to the instance with the smallest estimated queue drain."""
    name = "min_load"

    def __init__(self, est: BatchLatencyEstimator):
        self.est = est

    def select(self, req, prefill_pool, decode_pool, now,
               block_size=16, exec_est=None, affinity=None):
        live = [p for p in prefill_pool if p.alive]
        if not live:
            return None, None
        pick = min(live, key=lambda p: p.queue_exec_total(now))
        d_pick = None
        if decode_pool is not None:
            d_pick = pick_decode_target(decode_pool, req, block_size)
        return pick.iid, d_pick


class RoundRobin:
    name = "round_robin"

    def __init__(self, est=None):
        self._it = itertools.count()

    def select(self, req, prefill_pool, decode_pool, now,
               block_size=16, exec_est=None, affinity=None):
        live = [p for p in prefill_pool if p.alive]
        if not live:
            return None, None
        pick = live[next(self._it) % len(live)]
        d_pick = None
        if decode_pool is not None:
            d_live = [d for d in decode_pool if d.alive]
            need = decode_need_blocks(req, block_size)
            fits = [d for d in d_live
                    if d.effective_free >= need] or d_live
            if fits:
                d_pick = fits[next(self._it) % len(fits)].iid
        return pick.iid, d_pick


ROUTERS = {"gorouting": GoRouting, "min_load": MinLoad,
           "round_robin": RoundRobin}
