"""SlideBatching (§4.2, Alg. 1): load-adaptive local batch scheduler.

Per iteration:
  1.  refresh per-request metrics  exec / remain / density;
  2.  latency budget  t_budget = max(min_r remain, eta);
  3.  urgency partition:  URGENT iff remain < gamma * phi(Q)   (the sliding
      boundary — the URGENT/NORMAL split moves with load);
  4.  order: URGENT by density desc (fractional-knapsack greedy), then
      NORMAL by remaining time asc (EDF); starving requests jump the line;
  5.  compute the H2D copy budget (adaptive copy-budget control, §4.3);
  6.  admit requests in order, chunking prefill to saturate t_budget,
      consuming copy budget for evicted requests, evicting tail requests
      when device blocks run short.

A round that admits nothing while requests are queued names one reason in
``BatchPlan.idle_reason``: ``budget`` (the loop stopped before its first
admission, ``t_c >= t_budget``), else the refusal of the first request in
order that had work: ``copy`` (its reload got no copy budget) or
``blocks`` (no device blocks even after eviction); ``none_ready`` when no
queued request had work it could run.  The reason changes no decision.

The load-judgment function phi:
  PD co-location (Eq. 8):  phi(Q)   = t_budget/(t_budget - t_c) * sum exec
  PD disaggregation:       phi_p(Q) = sum exec + |Q| * t_c
"""
from __future__ import annotations

from dataclasses import dataclass

from .batching import (BatchEntry, BatchPlan, SchedView, compute_remaining,
                       exec_estimate, grow_with_eviction,
                       max_chunk_for_budget, next_token_weight,
                       needed_context)
from .blocks import blocks_for
from .request import Phase, Request
from .spec import AcceptanceEWMA, policy_depth

URGENT, NORMAL = 0, 1
# why a round admitted nothing (BatchPlan.idle_reason)
BUDGET, COPY, BLOCKS, NONE_READY = "budget", "copy", "blocks", "none_ready"


@dataclass
class _Metrics:
    exec: float
    remain: float
    density: float
    state: int = NORMAL


class SlideBatching:
    name = "slidebatching"

    def __init__(self, *, use_density: bool = True, use_deadline: bool = True,
                 latency_aware_budget: bool = True):
        # ablation switches (§5.4): "w/ only deadline" disables the density
        # ordering, "w/ only density" disables the deadline ordering,
        # "w/o latency-aware" replaces the time budget with a token budget.
        self.use_density = use_density
        self.use_deadline = use_deadline
        self.latency_aware_budget = latency_aware_budget
        # speculative-decoding feedback: acceptance-rate EWMA driving the
        # per-request depth policy (core/spec.py).  The engine/sim report
        # (proposed, accepted) back after every verify.
        self.spec_accept = AcceptanceEWMA()

    # ------------------------------------------------------------------
    def _phi(self, view: SchedView, metrics: dict[int, _Metrics],
             t_budget: float) -> float:
        total_exec = sum(m.exec for m in metrics.values())
        t_c = view.est.t_c
        if view.cfg.pd_mode == "prefill":
            return total_exec + len(metrics) * t_c          # phi_p
        denom = max(t_budget - t_c, 1e-9)
        return (t_budget / denom) * total_exec              # Eq. (8)

    def form_batch(self, view: SchedView) -> BatchPlan:
        cfg, now = view.cfg, view.now
        queue = [r for r in view.queue if r.phase != Phase.FINISHED]
        if not queue:
            return BatchPlan()

        # ---- lines 1-6: refresh metrics ---------------------------------
        # t_min considers only requests that can still make their next
        # deadline: an already-late request cannot be saved by shrinking
        # this batch (line 6's purpose is "no request misses its deadline
        # IN THE CURRENT BATCH"), it would only strangle throughput.
        metrics: dict[int, _Metrics] = {}
        t_min = float("inf")
        for r in queue:
            ex = exec_estimate(r, view)
            rem = r.remain(now)
            metrics[r.rid] = _Metrics(
                exec=ex, remain=rem,
                density=next_token_weight(r, cfg) / ex)
            if rem > 0:
                t_min = min(t_min, rem)

        # ---- line 7: latency budget --------------------------------------
        if self.latency_aware_budget:
            if t_min == float("inf"):
                # every queued request is already past its next deadline:
                # no deadline constrains this batch — use the top of the
                # budget's natural range [eta, max TPOT_SLO] (§4.2)
                t_min = max(r.slo.tpot for r in queue)
            t_budget = max(t_min, cfg.eta)
        else:
            t_budget = float("inf")   # ablation: capacity from token budget

        # ---- lines 8-12: adaptive urgency partition ----------------------
        phi = self._phi(view, metrics, t_budget if self.latency_aware_budget
                        else cfg.eta)
        for r in queue:
            m = metrics[r.rid]
            m.state = URGENT if m.remain < cfg.gamma * phi else NORMAL

        # ablations collapse the partition to a single strategy
        if not self.use_deadline:
            for m in metrics.values():
                m.state = URGENT
        if not self.use_density:
            for m in metrics.values():
                m.state = NORMAL

        # ---- line 13: ordering -------------------------------------------
        # starving requests (anti-starvation, wait > tau) jump to the head.
        for r in queue:
            if now - r.arrival > cfg.tau and r.generated == 0:
                r.starving = True

        def key(r: Request):
            m = metrics[r.rid]
            if r.starving:
                return (0, 0, -m.density, r.arrival)
            if m.state == URGENT:
                return (1, 0, -m.density, r.arrival)
            return (1, 1, m.remain, r.arrival)

        order = sorted(queue, key=key)
        # keep the view's queue in sorted order: the §4.3 eviction policy
        # and GoRouting's EstimateExec both read this ordering.
        view.queue[:] = order

        # ---- line 14: copy budget (§4.3 adaptive copy-budget control) ----
        copy_budget = self._copy_budget(view, order, metrics, t_budget)

        # ---- lines 15-23: admission ---------------------------------------
        plan = BatchPlan(t_budget=t_budget if self.latency_aware_budget else 0.0)
        t_batch = view.est.t_c
        protect: set[int] = set()
        token_cap = cfg.token_budget if not self.latency_aware_budget else None
        tokens_used = 0
        idle = ""
        for r in order:
            if len(plan.entries) >= cfg.max_seqs:
                break
            if self.latency_aware_budget:
                if t_batch >= t_budget:
                    idle = idle or BUDGET
                    break
                t_left = t_budget - t_batch
            else:
                if tokens_used >= token_cap:
                    idle = idle or BUDGET
                    break
                t_left = float("inf")

            entry, t, used_copy, why = self._admit(view, r, t_left,
                                                   token_cap, tokens_used,
                                                   copy_budget, protect,
                                                   plan)
            # reloads may have been applied even if admission then failed —
            # they consumed real H2D bandwidth either way.
            copy_budget -= used_copy
            plan.copy_blocks += used_copy
            if entry is None:
                if idle in ("", NONE_READY):
                    idle = why
                continue
            plan.entries.append(entry)
            protect.add(r.rid)
            t_batch += t
            tokens_used += entry.n_tokens
        plan.est_time = view.est.batch_time(plan.work_items())
        if not plan.entries:
            plan.idle_reason = idle
        return plan

    # ------------------------------------------------------------------
    def _copy_budget(self, view: SchedView, order: list[Request],
                     metrics: dict[int, _Metrics], t_budget: float) -> int:
        """GetCopyBudget: the §4.3 three-case decision over the likely batch."""
        bm, est = view.bm, view.est
        if not any(bm.state(r).host_tokens for r in order):
            return 0
        # prefix of the sorted queue that plausibly fits this round
        t_acc, prefix = est.t_c, []
        horizon = t_budget if t_budget != float("inf") else \
            est.prefill_time(view.cfg.token_budget)
        for r in order:
            prefix.append(r)
            t_acc += metrics[r.rid].exec
            if t_acc >= horizon:
                break
        t_fwd_min = min(t_acc, horizon)  # forward time if all host blocks restored
        b_missing, b_cold = 0, 0
        for r in prefix:
            s = bm.state(r)
            nb = blocks_for(s.host_tokens, bm.block_size)
            b_missing += nb
            if s.cold_tokens:
                b_cold += nb            # whole-group tiers: all-or-nothing
        # tier-aware transfer ceiling: cold int8 blocks cross the wire at
        # COLD_WIRE_RATIO width.  t_block_eff is passed ONLY when cold
        # blocks exist — (b*t)/b != t in fp, so the all-hot path must use
        # bm.t_block itself to stay bitwise-legacy.
        t_trans_max = est.reload_time(b_missing - b_cold, b_cold, bm.t_block)
        t_block_eff = t_trans_max / b_missing if b_cold else None
        return bm.copy_budget(t_fwd_min, t_trans_max,
                              horizon, b_missing, t_block_eff=t_block_eff)

    def _assign_depth(self, view: SchedView, r: Request, l_kv: int,
                      t0: float, t_left: float,
                      t_budget: float) -> tuple[int, float]:
        """Speculation depth for one decode admission.  Returns
        (depth, admission time incl. verify+draft overhead).

        Order of caps: the load/priority policy (core/spec.py), the
        remaining-output cap (never draft past output_len), the
        block-room cap (speculative KV slots must fit the blocks the
        plain grow-by-1 already reserves, so block accounting is
        untouched), the estimator's tokens/s pricing, and finally the
        budget collapse — depth steps toward 0 before the admission
        loop would shed this request from the batch.  The same method
        runs in the vectorized sim fast path, so depth decisions stay
        result-identical."""
        cfg, est = view.cfg, view.est
        k = cfg.spec_k
        if k <= 0 or r.output_len - r.generated <= 1:
            return 0, t0
        rate = self.spec_accept.rate
        load = 0.0
        if 0.0 < t_budget < float("inf"):
            load = 1.0 - t_left / t_budget
        d = int(policy_depth(load, r.priority, rate, k))
        d = min(d, r.output_len - r.generated - 1)
        bs = view.bm.block_size
        room = (bs - ((l_kv + 1) % bs)) % bs
        d = min(d, room)
        if d > 0:
            d = est.spec_depth(l_kv, d, rate)
        if d == 0 and room >= 1 and self.spec_accept.probe():
            # explore: policy/pricing declined but a depth-1 draft fits
            # the block — probe periodically so the acceptance estimate
            # can recover (zero-speculation is otherwise absorbing).
            d = 1
        while d > 0 and t0 + est.spec_overhead(l_kv, d) > t_left:
            d -= 1
        return d, (t0 + est.spec_overhead(l_kv, d)) if d else t0

    def _admit(self, view: SchedView, r: Request, t_left: float,
               token_cap, tokens_used: int, copy_budget: int,
               protect: set[int], plan: BatchPlan):
        """Lines 17-23 for one request. Returns (entry|None, time, copies,
        why it was refused or "")."""
        bm, est, cfg = view.bm, view.est, view.cfg
        s = bm.state(r)
        todo, _ = compute_remaining(r, bm)

        # --- reload coordination (SatisfyCopyCondition / ConsumeCopyBudget)
        used_copy = 0
        if s.host_tokens > 0:
            cap = token_cap - tokens_used if token_cap is not None else 1 << 30
            chunk_cap, _ = max_chunk_for_budget(est, s.dev_tokens, t_left,
                                                min(cap, max(todo, 1)))
            cplan = bm.plan_reload(r, copy_budget,
                                   max(chunk_cap, 1), max(todo, 1))
            if not cplan.admitted:
                return None, 0.0, 0, COPY   # line 19-20: skip this round
            if cplan.restore_blocks or cplan.drop_host_tokens:
                need = cplan.restore_blocks
                if need > bm.free_blocks:
                    from .batching import evict_for_space
                    plan.evictions.extend(
                        evict_for_space(view, need, protect | {r.rid}))
                if need > bm.free_blocks:
                    return None, 0.0, 0, BLOCKS
                bm.apply_reload(r, cplan, view.now)
                used_copy = cplan.restore_blocks
            todo, _ = compute_remaining(r, bm)

        # --- decode step (context fully resident) --------------------------
        if todo == 0 and r.phase == Phase.DECODE:
            l_kv = needed_context(r)
            t0 = est.decode_time(l_kv)
            depth, t = self._assign_depth(view, r, l_kv, t0, t_left,
                                          plan.t_budget)
            if t > t_left and plan.entries:
                return None, 0.0, used_copy, BUDGET
            if not grow_with_eviction(view, r, 1, protect | {r.rid},
                                      plan.evictions):
                return None, 0.0, used_copy, BLOCKS
            return BatchEntry(r, 1, l_kv, False, depth), t, used_copy, ""

        # --- (chunked) prefill / recompute ---------------------------------
        if todo <= 0:
            return None, 0.0, used_copy, NONE_READY
        cap = todo
        if token_cap is not None:
            cap = min(cap, token_cap - tokens_used)
        chunk, t = max_chunk_for_budget(est, s.dev_tokens, t_left, cap)
        if chunk == 0:
            # guarantee progress: an empty batch would stall the engine
            if not plan.entries:
                chunk = min(cap, max(1, view.cfg.chunk_size))
                t = est.prefill_time(chunk, s.dev_tokens)
            else:
                return None, 0.0, used_copy, BUDGET
        if not grow_with_eviction(view, r, chunk, protect | {r.rid},
                                  plan.evictions):
            return None, 0.0, used_copy, BLOCKS
        return (BatchEntry(r, chunk, s.dev_tokens - chunk, True), t,
                used_copy, "")
