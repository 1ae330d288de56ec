"""Single-instance engine simulation: iteration-level continuous batching.

One ``EngineSim`` = one serving instance (a TP group of chips).  Each
iteration the configured policy forms a batch (mutating the block manager:
growth/eviction/reload), the analytical executor provides ground-truth
latency, and output tokens are stamped at iteration end — the same
granularity real engines (vLLM/xLLM) schedule at.

Transfer critical-path rules (§4.3):
  * pipelined H2D reloads overlap compute; if the enqueued copies outlast
    the forward, the batch end extends to the copy completion (this is what
    the adaptive copy budget exists to prevent);
  * with synchronous offloading (the "w/o async" ablation) evictions stall
    the engine until the D2H copy drains.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.batching import (BatchPlan, EngineConfig, SchedView,
                             compute_remaining)
from ..core.blocks import BlockManager
from ..core.estimator import BatchLatencyEstimator
from ..core.prefix import SimPrefixCache
from ..core.request import Phase, Request
from ..core.spec import SIM_TRUE_ACCEPT_RATE, sim_accept_draw
from .executor import AnalyticalExecutor


@dataclass
class StepResult:
    end: float
    plan: BatchPlan
    emitted: list[Request] = field(default_factory=list)
    finished: list[Request] = field(default_factory=list)
    prefill_done: list[Request] = field(default_factory=list)


class DecodeAllPolicy:
    """PD-disaggregation decode instance: batch every ready decode (§4.2).
    Evicted requests whose KV was (partially) dropped are recomputed with
    chunked prefill so preemption on the decode tier cannot strand them."""
    name = "decode_all"

    def form_batch(self, view: SchedView) -> BatchPlan:
        from ..core.schedulers import (_admit_decode, _admit_prefill_chunk,
                                       _finalize)
        plan = BatchPlan()
        protect: set[int] = set()
        stranded = []
        for r in sorted(view.queue, key=lambda r: r.arrival):
            if r.phase == Phase.FINISHED:
                continue
            todo, _ = compute_remaining(r, view.bm)
            if todo == 0 and r.generated > 0:
                _admit_decode(view, r, plan, protect)
            elif todo > 0:
                stranded.append((r, todo))
        for r, todo in stranded:
            _admit_prefill_chunk(view, r, min(todo, view.cfg.chunk_size),
                                 plan, protect)
        return _finalize(view, plan)


class EngineSim:
    def __init__(self, iid: int, policy, executor: AnalyticalExecutor,
                 est: BatchLatencyEstimator, cfg: EngineConfig,
                 bm: Optional[BlockManager] = None,
                 prefix_cache: Optional[SimPrefixCache] = None):
        self.iid = iid
        self.policy = policy
        self.executor = executor
        self.est = est
        self.cfg = cfg
        self.bm = bm or BlockManager(executor.num_blocks,
                                     executor.block_size, executor.t_block,
                                     beta=cfg.beta)
        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            prefix_cache.bm = self.bm
            self.bm.cache = prefix_cache
        self.queue: list[Request] = []
        self.busy_until = 0.0
        self.idle = True
        self.alive = True
        self.iterations = 0
        self.prefill_tokens = 0    # prompt/recompute tokens actually computed
        self.copy_blocks = 0       # H2D reload blocks consumed (§4.3 lane;
        # the real engine counts the same signal in EngineStats.reload_blocks)
        self.batch_log: list[tuple[float, int, float]] = []  # (t, n, latency)
        # speculative decoding mirror (cfg.spec_k > 0): per-entry depth
        # comes from the policy's BatchPlan; acceptance is drawn from the
        # deterministic oracle below (overridable, e.g. perf_smoke pins
        # always-accept to match an equal-params live run) at the fixed
        # workload truth ``spec_true_rate`` — the policy's EWMA then
        # estimates that truth from outcomes, like the live engine
        # estimates draft/target agreement.  Counters use the live
        # EngineStats names so sim<->live parity is dict equality.
        self.spec_accept_fn = sim_accept_draw
        self.spec_true_rate = SIM_TRUE_ACCEPT_RATE
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_depth_hist: dict[int, int] = {}

    # ------------------------------------------------------------------
    def add_request(self, req: Request, now: float) -> None:
        req.instance = self.iid
        self.queue.append(req)
        if self.prefix_cache is not None:
            hit = self.prefix_cache.match(req, now)
            req.prefilled = hit
            if hit:
                self.bm.attach_cached(req, hit)
                self.prefix_cache.attach(req.rid, req.prefix_group)

    def has_work(self) -> bool:
        return any(r.phase != Phase.FINISHED for r in self.queue)

    def kill(self) -> list[Request]:
        """Instance failure: return unfinished requests for re-dispatch.
        Device state is lost — residency resets (host copies die with the
        host of this instance's node in the worst case, which we assume)."""
        self.alive = False
        orphans = [r for r in self.queue if r.phase != Phase.FINISHED]
        for r in orphans:
            self.bm.release(r)
            r.instance = None
        self.queue.clear()
        return orphans

    # ------------------------------------------------------------------
    def step(self, now: float) -> Optional[StepResult]:
        if not self.alive:
            return None
        self.bm.complete_offloads(now)
        view = SchedView(self.queue, self.bm, self.est, self.cfg, now)
        plan = self.policy.form_batch(view)
        if not plan.entries:
            self.idle = True
            return None
        self.idle = False
        latency = self.executor.batch_latency(plan.work_items())
        if self.cfg.spec_k > 0:
            # verify rows + draft steps ride the same launch: price the
            # per-entry overhead on top of the plain decode batch time
            latency += sum(self.est.spec_overhead(e.l_kv, e.depth)
                           for e in plan.entries if e.depth > 0)
        end = now + latency
        # pipelined reload that outlasts the forward extends the batch
        end = max(end, self.bm.h2d.busy_until)
        # synchronous offload stalls (w/o-async ablation)
        if not self.bm.async_offload and not self.bm.recompute_only:
            end = max(end, self.bm.d2h.busy_until)

        res = StepResult(end=end, plan=plan)
        for e in plan.entries:
            r = e.req
            s = self.bm.state(r)
            if e.is_prefill:
                self.prefill_tokens += e.n_tokens
                # the pass that brings residency to prompt_len produces the
                # first token; recompute passes for resumed decodes emit
                # nothing (their next decode pass does).
                if r.generated == 0 and s.dev_tokens >= r.prompt_len:
                    r.emit_token(end)
                    res.emitted.append(r)
                    res.prefill_done.append(r)
                    if self.prefix_cache is not None:
                        adopted = self.prefix_cache.insert(r, end)
                        if adopted:
                            self.bm.donate_to_cache(r, adopted)
                        self.prefix_cache.shrink_to_capacity()
            else:
                accepted = 0
                if e.depth > 0:
                    accepted = self.spec_accept_fn(
                        r.rid, r.generated, e.depth, self.spec_true_rate)
                    self.policy.spec_accept.update(e.depth, accepted)
                if self.cfg.spec_k > 0:
                    self.spec_proposed += e.depth
                    self.spec_accepted += accepted
                    self.spec_rejected += e.depth - accepted
                    self.spec_depth_hist[e.depth] = \
                        self.spec_depth_hist.get(e.depth, 0) + 1
                r.emit_token(end)
                res.emitted.append(r)
                for _ in range(accepted):
                    # bonus tokens verified this step: same timestamp (one
                    # launch), context advances within the blocks already
                    # reserved (depth was capped to the block remainder)
                    r.emit_token(end)
                s.dev_tokens += accepted
            if r.phase == Phase.FINISHED:
                r.finish_time = end
                self.bm.release(r)
                res.finished.append(r)
        self.queue = [r for r in self.queue if r.phase != Phase.FINISHED]
        self.busy_until = end
        self.iterations += 1
        self.copy_blocks += plan.copy_blocks
        self.batch_log.append((now, len(plan.entries), end - now))
        return res

    # --- PD-disaggregation handoff --------------------------------------
    def export_request(self, req: Request) -> int:
        """Prefill side: release blocks after KV push; returns pushed tokens."""
        s = self.bm.state(req)
        tokens = s.dev_tokens
        self.bm.release(req)
        self.queue = [r for r in self.queue if r.rid != req.rid]
        return tokens

    def import_request(self, req: Request, tokens: int, now: float) -> bool:
        """Decode side: account the pushed KV blocks."""
        req.instance = self.iid
        ok = self.bm.grow(req, tokens, now)
        if not ok:
            # decode pool exhausted: evict per policy to make room
            from ..core.batching import evict_for_space
            view = SchedView(self.queue, self.bm, self.est, self.cfg, now)
            need = self.bm.blocks_needed_for_growth(req, tokens)
            evict_for_space(view, need, {req.rid})
            ok = self.bm.grow(req, tokens, now)
        self.queue.append(req)
        return ok
