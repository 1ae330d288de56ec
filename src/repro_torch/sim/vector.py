"""Vectorized SlideBatching + ClusterSim wrapper for 10⁵–10⁶-request traces.

``SlideBatching.form_batch`` dominates large replays (profiling a 2·10³
request coloc replay puts ~85 % of wall time inside it: per-request metric
dicts, Python ``sorted``, and per-request ``_admit`` calls).  This module
re-implements the hot path with numpy columns while keeping the
``Request`` / ``BlockManager`` objects authoritative — state mutations go
through exactly the same code paths.

EQUIVALENCE CONTRACT (docs/ARCHITECTURE.md "Vectorized simulation"): for
any queue state, ``VectorSlideBatching.form_batch`` produces a bitwise
identical ``BatchPlan`` (same entries in the same order, same chunk sizes,
same evictions, same ``est_time``/``t_budget``/``copy_blocks``) and leaves
the block manager in the same state as ``SlideBatching.form_batch``.
``tests/test_vector_sim.py`` asserts this end-to-end: per-request token
timestamps, finish times and preemption counts must match exactly across
priority mixes, overload, kills and PD disaggregation.

The rules that make the contract hold:

* every vectorized formula keeps the scalar code's floating-point
  expression shape (same association order, e.g. ``a_p*todo*todo`` not
  ``a_p*todo**2``), so IEEE-754 results are identical elementwise;
* reductions that the scalar code performs sequentially use
  ``np.add.accumulate(...)[-1]`` — NOT ``np.sum`` (pairwise) — masked
  contributions enter as ``+0.0`` which is exact for the non-negative
  terms involved;
* ordering uses ``np.lexsort`` which, like ``sorted``, is stable, with the
  same key tuple (starving, urgent, -density | remain, arrival);
* admission walks the sorted order with the same break conditions,
  re-reading LIVE ``ReqBlocks`` state each step so evictions triggered by
  earlier admissions are observed exactly as in the reference loop; any
  case the fast path does not model bit-exactly (host-resident tokens,
  block-pool pressure) falls back to the inherited ``_admit``.
"""
from __future__ import annotations

import numpy as np

from ..core.batching import (BatchEntry, BatchPlan, SchedView,
                             grow_with_eviction, max_chunk_for_budget)
from ..core.request import Phase
from ..core.slidebatching import NORMAL, URGENT, SlideBatching, _Metrics
from .cluster import ClusterSim

# below this queue length the columnar gather costs more than it saves
MIN_VECTOR_QUEUE = 4


class VectorSlideBatching(SlideBatching):
    """Drop-in SlideBatching with a vectorized ``form_batch`` hot path."""

    name = "slidebatching_vec"

    def form_batch(self, view: SchedView) -> BatchPlan:
        if not self.latency_aware_budget:
            # token-budget ablation: cold path, keep the reference loop
            return super().form_batch(view)
        queue = [r for r in view.queue if r.phase != Phase.FINISHED]
        n = len(queue)
        if n < MIN_VECTOR_QUEUE:
            return super().form_batch(view)
        cfg, now, bm, est = view.cfg, view.now, view.bm, view.est

        # ---- columnar gather (objects stay authoritative) ----------------
        # bm.state() (not bm.table[...]) so the setdefault side effect of
        # the scalar path is preserved for fresh requests.
        states = [bm.state(r) for r in queue]
        arrival = np.empty(n)
        weight = np.empty(n)
        ttft = np.empty(n)
        tpot = np.empty(n)
        gen = np.empty(n, np.int64)
        prompt = np.empty(n, np.int64)
        dev = np.empty(n, np.int64)
        host = np.empty(n, np.int64)
        starv = np.empty(n, bool)
        for i, r in enumerate(queue):
            s = states[i]
            arrival[i] = r.arrival
            weight[i] = r.weight
            slo = r.slo
            ttft[i] = slo.ttft
            tpot[i] = slo.tpot
            gen[i] = len(r.out_times)
            prompt[i] = r.prompt_len
            dev[i] = s.dev_tokens
            host[i] = s.host_tokens
            starv[i] = r.starving

        # ---- Alg. 1 lines 1-6: metrics (exec / remain / density) ---------
        needed = prompt + np.maximum(gen - 1, 0)       # needed_context
        resident = dev + host
        todo = np.maximum(needed - resident, 0)        # compute_remaining
        pre_t = est.a_p * todo * todo + est.b_p * todo * resident \
            + est.c_p * todo                           # prefill_time
        dec_t = est.a_d * (needed + 1) + est.b_d       # decode_time(ctx+1)
        t_exec = np.where(todo > 0, pre_t, 0.0) + np.where(gen > 0, dec_t,
                                                           0.0)
        t_exec = np.maximum(t_exec, 1e-9)
        remain = arrival + ttft + gen * tpot - now     # r.remain(now)
        density = np.where(gen == 0, cfg.w_p, cfg.w_d) * weight / t_exec

        # ---- line 7: latency budget --------------------------------------
        pos = remain > 0
        t_min = float(np.min(remain[pos])) if pos.any() else float(
            np.max(tpot))
        t_budget = max(t_min, cfg.eta)

        # ---- lines 8-12: urgency partition (phi, Eq. 8) ------------------
        total_exec = float(np.add.accumulate(t_exec)[-1])
        t_c = est.t_c
        if cfg.pd_mode == "prefill":
            phi = total_exec + n * t_c                 # phi_p
        else:
            phi = (t_budget / max(t_budget - t_c, 1e-9)) * total_exec
        urgent = remain < cfg.gamma * phi
        if not self.use_deadline:
            urgent = np.ones(n, bool)
        if not self.use_density:
            urgent = np.zeros(n, bool)

        # ---- line 13: ordering (starvation promotion + stable sort) ------
        fresh_starv = (~starv) & (gen == 0) & (now - arrival > cfg.tau)
        if fresh_starv.any():
            for i in np.nonzero(fresh_starv)[0]:
                queue[i].starving = True
            starv = starv | fresh_starv
        head = starv | urgent
        k1 = (~starv).astype(np.int64)                 # starving first
        k2 = (~head).astype(np.int64)                  # then urgent
        k3 = np.where(head, -density, remain)          # greedy | EDF
        idx = np.lexsort((arrival, k3, k2, k1))
        order = [queue[i] for i in idx]
        view.queue[:] = order

        # ---- line 14: adaptive copy budget -------------------------------
        if not host.any():
            copy_budget = 0
        else:
            metrics = {r.rid: _Metrics(
                exec=float(t_exec[i]), remain=float(remain[i]),
                density=float(density[i]),
                state=URGENT if urgent[i] else NORMAL)
                for i, r in enumerate(queue)}
            copy_budget = self._copy_budget(view, order, metrics, t_budget)

        # ---- lines 15-23: admission --------------------------------------
        plan = BatchPlan(t_budget=t_budget)
        entries = plan.entries
        t_batch = t_c
        dec_admit = est.a_d * needed + est.b_d         # decode_time(ctx)
        admitted: list[int] = []
        protect: set[int] | None = None                # built lazily
        bs = bm.block_size
        fast_offload = bm.async_offload and not bm.recompute_only
        n_off_map = bm.n_off_by_priority
        n_off_default = max(n_off_map.values())
        lq_col: list[int] = []
        lkv_col: list[int] = []
        isp_col: list[bool] = []
        max_seqs = cfg.max_seqs

        for j in range(n):
            if len(entries) >= max_seqs:
                break
            if t_batch >= t_budget:
                break
            t_left = t_budget - t_batch
            i = int(idx[j])
            r = queue[i]
            s = states[i]
            if s.host_tokens > 0:
                # reload coordination: reference path (consumes copy budget)
                if protect is None:
                    protect = set(admitted)
                entry, t, used_copy = self._admit(view, r, t_left, None, 0,
                                                  copy_budget, protect, plan)
                copy_budget -= used_copy
                plan.copy_blocks += used_copy
                if entry is None:
                    continue
                entries.append(entry)
                protect.add(r.rid)
                admitted.append(r.rid)
                t_batch += t
                lq_col.append(entry.n_tokens)
                lkv_col.append(entry.l_kv)
                isp_col.append(entry.is_prefill)
                continue
            needed_i = int(needed[i])
            dev_now = s.dev_tokens
            if needed_i <= dev_now:                    # todo == 0
                if gen[i] == 0:
                    continue                           # nothing to compute
                # --- decode step (context fully resident) -----------------
                t = float(dec_admit[i])
                depth = 0
                if cfg.spec_k > 0:
                    depth, t = self._assign_depth(view, r, needed_i, t,
                                                  t_left, t_budget)
                if t > t_left and entries:
                    continue
                need_blk = 1 if dev_now % bs == 0 else 0
                if need_blk > bm.free_blocks:
                    if protect is None:
                        protect = set(admitted)
                    if not grow_with_eviction(view, r, 1, protect | {r.rid},
                                              plan.evictions):
                        continue
                else:
                    s.dev_tokens = dev_now + 1
                    bm.used_blocks += need_blk
                    if fast_offload:
                        full = s.dev_tokens // bs
                        if full - s.mirrored_blocks - s.pending_offload >= \
                                n_off_map.get(r.priority, n_off_default):
                            bm._maybe_offload(r, now)
                entries.append(BatchEntry(r, 1, needed_i, False, depth))
                lkv_col.append(needed_i)
                lq_col.append(1)
                isp_col.append(False)
            else:
                # --- (chunked) prefill / recompute ------------------------
                cap = needed_i - dev_now
                chunk, t = max_chunk_for_budget(est, dev_now, t_left, cap)
                if chunk == 0:
                    if entries:
                        continue
                    chunk = min(cap, max(1, cfg.chunk_size))
                    t = est.prefill_time(chunk, dev_now)
                need_blk = (dev_now + chunk + bs - 1) // bs \
                    - (dev_now + bs - 1) // bs
                if need_blk > bm.free_blocks:
                    if protect is None:
                        protect = set(admitted)
                    if not grow_with_eviction(view, r, chunk,
                                              protect | {r.rid},
                                              plan.evictions):
                        continue
                else:
                    s.dev_tokens = dev_now + chunk
                    bm.used_blocks += need_blk
                    if fast_offload:
                        full = s.dev_tokens // bs
                        if full - s.mirrored_blocks - s.pending_offload >= \
                                n_off_map.get(r.priority, n_off_default):
                            bm._maybe_offload(r, now)
                entries.append(BatchEntry(r, chunk, s.dev_tokens - chunk,
                                          True))
                lkv_col.append(s.dev_tokens - chunk)
                lq_col.append(chunk)
                isp_col.append(True)
            admitted.append(r.rid)
            if protect is not None:
                protect.add(r.rid)
            t_batch += t

        plan.est_time = est.batch_time_cols(lq_col, lkv_col, isp_col)
        return plan


def vectorize_policy(policy):
    """Swap a reference ``SlideBatching`` for its vectorized equivalent;
    other policies (baselines, ``DecodeAllPolicy``) pass through unchanged
    — they run the reference code and trivially satisfy the contract."""
    if type(policy) is SlideBatching:
        return VectorSlideBatching(
            use_density=policy.use_density,
            use_deadline=policy.use_deadline,
            latency_aware_budget=policy.latency_aware_budget)
    return policy


class VectorClusterSim(ClusterSim):
    """ClusterSim whose local schedulers are vectorized transparently.

    Construction args are identical to :class:`ClusterSim`; the policy
    factory's products are passed through :func:`vectorize_policy`, so
    ``VectorClusterSim(lambda: make_policy("slidebatching"), ...)`` replays
    a trace with per-request results identical to the reference simulator.
    """

    def __init__(self, make_policy_fn, *args, **kwargs):
        super().__init__(lambda: vectorize_policy(make_policy_fn()),
                         *args, **kwargs)
