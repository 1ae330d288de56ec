"""Baseline batch schedulers (§5.1) implemented against the same SchedView /
BatchPlan interface as SlideBatching so every policy runs inside the
identical engine — mirroring the paper's "all schedulers implemented within
xLLM" methodology.

* vLLM-FCFS        — prefill-prioritized FCFS, whole-prompt admission,
                     recompute preemption (vLLM default).
* Sarathi-FCFS     — chunked prefill, decode-prioritized, FCFS among
                     waiting prefills, profiled token budget.
* Sarathi-Priority — Sarathi with waiting queue ordered by (priority, arrival).
* FairBatching     — enhanced EDF: decodes near deadline > prefills (EDF) >
                     remaining decodes.
* Weighted VTC     — CFS-style weighted virtual token counters per client.
* EDF / SJF / Priority-First — classic orderings (§3 motivation studies).

For 10⁵-request replays every policy has a columnar fast path: queues of
``_MIN_COLS``+ rows are partitioned and sorted through numpy columns
(``_scan`` / ``_ordered``) instead of per-request Python.  The fast path
follows the ``sim/vector.py`` equivalence contract — integer predicates,
scalar-shaped float expressions, stable ``np.lexsort`` — so it is bitwise
identical to the scalar loops (asserted in tests/test_scheduling.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .batching import (BatchEntry, BatchPlan, SchedView, compute_remaining,
                       exec_estimate, grow_with_eviction, needed_context)
from .request import Phase, Request

# same columnar threshold as estimator._features / sim.vector
_MIN_COLS = 32


# --------------------------------------------------------------------------
# shared mechanics
# --------------------------------------------------------------------------

def _scan(view: SchedView) -> tuple[list[Request], list[Request]]:
    """One queue scan -> (ready decodes, prefillable requests), both in
    queue order.  The columnar path's partition predicate is all-integer
    (``todo = max(needed - resident, 0)``) so it is trivially identical
    to the scalar loop."""
    queue, bm = view.queue, view.bm
    if len(queue) < _MIN_COLS:
        decs, pref = [], []
        for r in queue:
            if r.phase == Phase.FINISHED:
                continue
            todo, _ = compute_remaining(r, bm)
            if todo > 0:
                pref.append(r)
            elif r.phase == Phase.DECODE:
                decs.append(r)
        return decs, pref
    n = len(queue)
    resident = np.zeros(n, np.int64)
    needed = np.zeros(n, np.int64)
    is_dec = np.zeros(n, bool)
    live = np.zeros(n, bool)
    for i, r in enumerate(queue):
        ph = r.phase
        if ph == Phase.FINISHED:
            continue    # scalar loops never touch bm.state for these
        live[i] = True
        is_dec[i] = ph == Phase.DECODE
        s = bm.state(r)
        resident[i] = s.dev_tokens + s.host_tokens
        needed[i] = r.prompt_len + max(0, r.generated - 1)
    todo = np.maximum(needed - resident, 0)
    decs = [queue[i] for i in np.nonzero(is_dec & (todo == 0))[0]]
    pref = [queue[i] for i in np.nonzero(live & (todo > 0))[0]]
    return decs, pref


def _decodes(view: SchedView) -> list[Request]:
    return _scan(view)[0]


def _prefillable(view: SchedView) -> list[Request]:
    return _scan(view)[1]


def _ordered(reqs: list[Request], key_fn,
             cols_fn=None) -> list[Request]:
    """``sorted(reqs, key=key_fn)`` with a columnar fast path: for
    ``_MIN_COLS``+ rows ``cols_fn(reqs)`` supplies the key columns
    (most-significant first) and a stable ``np.lexsort`` reproduces the
    scalar sort exactly — same key values, same tie-breaking stability."""
    if cols_fn is not None and len(reqs) >= _MIN_COLS:
        cols = cols_fn(reqs)
        if cols is not None:
            idx = np.lexsort(tuple(reversed(cols)))
            return [reqs[i] for i in idx]
    return sorted(reqs, key=key_fn)


def _arrival_cols(reqs: list[Request]) -> tuple[np.ndarray, ...]:
    return (np.fromiter((r.arrival for r in reqs), np.float64, len(reqs)),)


def _priority_cols(reqs: list[Request]) -> np.ndarray:
    return np.fromiter((r.priority for r in reqs), np.int64, len(reqs))


def _remain_col(reqs: list[Request], now: float) -> np.ndarray:
    """Columnar ``r.remain(now)``: the expression keeps the scalar
    association ``((arrival + ttft) + gen*tpot) - now`` (see
    ``SLO.token_deadline``) so each element is bitwise the scalar value."""
    n = len(reqs)
    arrival = np.fromiter((r.arrival for r in reqs), np.float64, n)
    ttft = np.fromiter((r.slo.ttft for r in reqs), np.float64, n)
    tpot = np.fromiter((r.slo.tpot for r in reqs), np.float64, n)
    gen = np.fromiter((r.generated for r in reqs), np.int64, n)
    return arrival + ttft + gen * tpot - now


def _exec_cols(view: SchedView, reqs: list[Request]) -> tuple[np.ndarray]:
    """Columnar ``exec_estimate`` (same float expression shapes as the
    scalar ``prefill_time`` / ``decode_time`` calls)."""
    est, bm = view.est, view.bm
    n = len(reqs)
    resident = np.empty(n, np.int64)
    needed = np.empty(n, np.int64)
    gen = np.empty(n, np.int64)
    for i, r in enumerate(reqs):
        s = bm.state(r)
        resident[i] = s.dev_tokens + s.host_tokens
        needed[i] = r.prompt_len + max(0, r.generated - 1)
        gen[i] = r.generated
    todo = np.maximum(needed - resident, 0)
    pre_t = est.a_p * todo * todo + est.b_p * todo * resident \
        + est.c_p * todo
    dec_t = est.a_d * (needed + 1) + est.b_d
    t = np.where(todo > 0, pre_t, 0.0) + np.where(gen > 0, dec_t, 0.0)
    return (np.maximum(t, 1e-9),)


def _restore_all_host(view: SchedView, r: Request,
                      plan: BatchPlan, protect: set[int]) -> bool:
    """Baselines restore any host-resident KV in full before running (they
    have no adaptive copy budget; w/o-dynamic behaviour)."""
    s = view.bm.state(r)
    if s.host_tokens == 0:
        return True
    cplan = view.bm.plan_reload(r, 1 << 30, 1 << 30, 1 << 30)
    need = cplan.restore_blocks
    if need > view.bm.free_blocks:
        from .batching import evict_for_space
        plan.evictions.extend(evict_for_space(view, need, protect | {r.rid}))
    if need > view.bm.free_blocks:
        return False
    view.bm.apply_reload(r, cplan, view.now)
    plan.copy_blocks += need
    return True


def _admit_decode(view: SchedView, r: Request, plan: BatchPlan,
                  protect: set[int]) -> bool:
    if not _restore_all_host(view, r, plan, protect):
        return False
    if not grow_with_eviction(view, r, 1, protect | {r.rid}, plan.evictions):
        return False
    plan.entries.append(BatchEntry(r, 1, needed_context(r), False))
    protect.add(r.rid)
    return True


def _admit_prefill_chunk(view: SchedView, r: Request, max_tokens: int,
                         plan: BatchPlan, protect: set[int]) -> int:
    """Admit up to ``max_tokens`` of (re)compute for r; returns tokens taken."""
    if not _restore_all_host(view, r, plan, protect):
        return 0
    todo, _ = compute_remaining(r, view.bm)
    chunk = min(todo, max_tokens)
    if chunk <= 0:
        return 0
    l_kv = view.bm.state(r).dev_tokens
    if not grow_with_eviction(view, r, chunk, protect | {r.rid},
                              plan.evictions):
        return 0
    plan.entries.append(BatchEntry(r, chunk, l_kv, True))
    protect.add(r.rid)
    return chunk


def _finalize(view: SchedView, plan: BatchPlan) -> BatchPlan:
    plan.est_time = view.est.batch_time(plan.work_items())
    return plan


# --------------------------------------------------------------------------
# vLLM default: prefill-prioritized FCFS, whole prompts, no chunking
# --------------------------------------------------------------------------

class VllmFCFS:
    name = "vllm_fcfs"

    def form_batch(self, view: SchedView) -> BatchPlan:
        plan = BatchPlan()
        protect: set[int] = set()
        cfg = view.cfg
        decs, pref = _scan(view)
        waiting = _ordered(pref, lambda r: r.arrival, _arrival_cols)
        budget = cfg.token_budget
        # admit WHOLE prompts FCFS while they fit the token budget; a prompt
        # longer than the whole budget runs ALONE (vLLM requires
        # max_num_batched_tokens >= max_model_len — emulated by lifting the
        # cap for a single head-of-line sequence instead of stalling it)
        for r in waiting:
            todo, _ = compute_remaining(r, view.bm)
            if len(plan.entries) >= cfg.max_seqs:
                break
            if todo > budget:
                if not plan.entries:
                    _admit_prefill_chunk(view, r, todo, plan, protect)
                break
            taken = _admit_prefill_chunk(view, r, todo, plan, protect)
            if taken == 0:
                break
            budget -= taken
        if plan.entries:          # vLLM v0: prefill batches run alone
            return _finalize(view, plan)
        for r in _ordered(decs, lambda r: r.arrival, _arrival_cols):
            if len(plan.entries) >= cfg.max_seqs:
                break
            _admit_decode(view, r, plan, protect)
        return _finalize(view, plan)


# --------------------------------------------------------------------------
# Sarathi family: decode-prioritized + chunked prefill under token budget
# --------------------------------------------------------------------------

class _SarathiBase:
    def _waiting_order(self, view: SchedView) -> Callable[[Request], tuple]:
        raise NotImplementedError

    def _waiting_cols(self, view: SchedView,
                      reqs: list[Request]) -> Optional[tuple]:
        """Columnar key columns matching ``_waiting_order`` (most
        significant first); None = no fast path for this policy."""
        return None

    def form_batch(self, view: SchedView) -> BatchPlan:
        plan = BatchPlan()
        protect: set[int] = set()
        cfg = view.cfg
        budget = cfg.token_budget
        decs, pref = _scan(view)
        for r in _ordered(decs, lambda r: r.arrival, _arrival_cols):
            if len(plan.entries) >= cfg.max_seqs or budget <= 0:
                break
            if _admit_decode(view, r, plan, protect):
                budget -= 1
        key = self._waiting_order(view)
        for r in _ordered(pref, key,
                          lambda reqs: self._waiting_cols(view, reqs)):
            if budget <= 0 or len(plan.entries) >= cfg.max_seqs:
                break
            chunk = min(budget, cfg.chunk_size)
            budget -= _admit_prefill_chunk(view, r, chunk, plan, protect)
        return _finalize(view, plan)


class SarathiFCFS(_SarathiBase):
    name = "sarathi_fcfs"

    def _waiting_order(self, view):
        return lambda r: (r.arrival,)

    def _waiting_cols(self, view, reqs):
        return _arrival_cols(reqs)


class SarathiPriority(_SarathiBase):
    name = "sarathi_priority"

    def _waiting_order(self, view):
        return lambda r: (r.priority, r.arrival)   # priority 1 first, then FCFS

    def _waiting_cols(self, view, reqs):
        return (_priority_cols(reqs),) + _arrival_cols(reqs)


class EDF(_SarathiBase):
    name = "edf"

    def _waiting_order(self, view):
        now = view.now
        return lambda r: (r.remain(now),)

    def _waiting_cols(self, view, reqs):
        return (_remain_col(reqs, view.now),)


class SJF(_SarathiBase):
    name = "sjf"

    def _waiting_order(self, view):
        return lambda r: (exec_estimate(r, view),)

    def _waiting_cols(self, view, reqs):
        return _exec_cols(view, reqs)


class PriorityFirst(_SarathiBase):
    """Strict priority-first (§3.1 motivation): priority dominates everything,
    including the decode/prefill split — emulated by ordering waiting work by
    priority and letting high-priority prefills consume the whole budget."""
    name = "priority_first"

    def _waiting_order(self, view):
        return lambda r: (r.priority, r.remain(view.now))

    def _waiting_cols(self, view, reqs):
        return (_priority_cols(reqs), _remain_col(reqs, view.now))


# --------------------------------------------------------------------------
# FairBatching: decodes near deadline > EDF prefills > remaining decodes
# --------------------------------------------------------------------------

class FairBatching:
    name = "fair_batching"

    def __init__(self, urgency_factor: float = 2.0):
        self.urgency_factor = urgency_factor

    def form_batch(self, view: SchedView) -> BatchPlan:
        plan = BatchPlan()
        protect: set[int] = set()
        cfg, now = view.cfg, view.now
        budget = cfg.token_budget
        decodes, pref = _scan(view)
        if len(decodes) >= _MIN_COLS:
            # columnar urgency split: the threshold keeps the scalar
            # expression (python-float ``factor * tpot``) per element
            rem = _remain_col(decodes, now)
            thresh = np.fromiter(
                (self.urgency_factor * r.slo.tpot for r in decodes),
                np.float64, len(decodes))
            mask = rem < thresh
            urgent = [decodes[i] for i in np.nonzero(mask)[0]]
            rest = [decodes[i] for i in np.nonzero(~mask)[0]]
        else:
            urgent, rest = [], []
            for r in decodes:
                slack = r.remain(now)
                if slack < self.urgency_factor * r.slo.tpot:
                    urgent.append(r)
                else:
                    rest.append(r)
        remain_cols = lambda rs: (_remain_col(rs, now),)  # noqa: E731
        for r in _ordered(urgent, lambda r: r.remain(now), remain_cols):
            if budget <= 0 or len(plan.entries) >= cfg.max_seqs:
                break
            if _admit_decode(view, r, plan, protect):
                budget -= 1
        for r in _ordered(pref, lambda r: r.remain(now), remain_cols):
            if budget <= 0 or len(plan.entries) >= cfg.max_seqs:
                break
            chunk = min(budget, cfg.chunk_size)
            budget -= _admit_prefill_chunk(view, r, chunk, plan, protect)
        for r in _ordered(rest, lambda r: r.remain(now), remain_cols):
            if budget <= 0 or len(plan.entries) >= cfg.max_seqs:
                break
            if _admit_decode(view, r, plan, protect):
                budget -= 1
        return _finalize(view, plan)


# --------------------------------------------------------------------------
# Weighted VTC (OSDI'24 fairness) — CFS-like weighted virtual token counters
# --------------------------------------------------------------------------

class WeightedVTC:
    """Clients accrue virtual time = served_tokens / weight; each round the
    scheduler serves the client with the LOWEST counter first, so processed
    token ratios track priority weights.  No SLO awareness (the paper's
    point: fairness alone cannot guarantee latency)."""
    name = "weighted_vtc"

    def __init__(self):
        self.counters: dict[int, float] = {}

    def _vt(self, client: int) -> float:
        return self.counters.get(client, 0.0)

    def _charge(self, r: Request, tokens: int) -> None:
        self.counters[r.client] = self._vt(r.client) + tokens / max(r.weight, 1e-9)

    def form_batch(self, view: SchedView) -> BatchPlan:
        plan = BatchPlan()
        protect: set[int] = set()
        cfg = view.cfg
        budget = cfg.token_budget
        # lift counters of newly active clients to min active counter (VTC)
        active = {r.client for r in view.queue if r.phase != Phase.FINISHED}
        if active:
            base = min(self._vt(c) for c in active)
            for c in active:
                if c not in self.counters:
                    self.counters[c] = base
        # decodes keep running (stall-free), charged to their clients
        decs, pref = _scan(view)

        def vt_cols(reqs):
            return (np.fromiter((self._vt(r.client) for r in reqs),
                                np.float64, len(reqs)),)

        for r in _ordered(decs, lambda r: self._vt(r.client), vt_cols):
            if budget <= 0 or len(plan.entries) >= cfg.max_seqs:
                break
            if _admit_decode(view, r, plan, protect):
                self._charge(r, 1)
                budget -= 1
        for r in _ordered(pref,
                          lambda r: (self._vt(r.client), r.arrival),
                          lambda reqs: vt_cols(reqs) + _arrival_cols(reqs)):
            if budget <= 0 or len(plan.entries) >= cfg.max_seqs:
                break
            chunk = min(budget, cfg.chunk_size)
            taken = _admit_prefill_chunk(view, r, chunk, plan, protect)
            if taken:
                self._charge(r, taken)
                budget -= taken
        return _finalize(view, plan)


POLICIES: dict[str, Callable[[], object]] = {
    "vllm_fcfs": VllmFCFS,
    "sarathi_fcfs": SarathiFCFS,
    "sarathi_priority": SarathiPriority,
    "fair_batching": FairBatching,
    "weighted_vtc": WeightedVTC,
    "edf": EDF,
    "sjf": SJF,
    "priority_first": PriorityFirst,
}


def make_policy(name: str, **kw):
    if name == "slidebatching":
        from .slidebatching import SlideBatching
        return SlideBatching(**kw)
    return POLICIES[name](**kw)
