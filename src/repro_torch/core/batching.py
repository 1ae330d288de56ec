"""Shared batch-formation types used by SlideBatching, all baselines, the
cluster simulator and the real JAX engine.

A scheduling policy sees a ``SchedView`` (queue + block manager + latency
estimator + engine config) and returns a ``BatchPlan``: which requests run
this iteration, how many tokens each processes (chunked prefill), which
requests are evicted, and which KV blocks are reloaded.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Protocol

from .blocks import BlockManager
from .estimator import BatchLatencyEstimator
from .request import Phase, Request


@dataclass
class EngineConfig:
    # SlideBatching knobs (§4.2)
    eta: float = 0.05            # lower bound on the latency budget (s)
    gamma: float = 0.9           # aggressiveness coefficient
    tau: float = 30.0            # starvation threshold (s)
    beta: float = 1.5            # partial-copy effective-progress threshold
    # capacity knobs used by the token-budget baselines
    token_budget: int = 2048     # max_num_batched_tokens
    max_seqs: int = 256          # max_num_seqs
    chunk_size: int = 512        # sarathi chunk
    # gain weights
    w_p: float = 4.0             # first-token weight
    w_d: float = 1.0             # decode-token weight
    # deployment
    pd_mode: str = "coloc"       # "coloc" | "prefill" | "decode"
    # speculative decoding: max draft depth k (0 = off).  The per-request
    # depth in [0, spec_k] is a scheduler decision (core/spec.py policy +
    # estimator pricing); the engine/sim execute whatever depth the plan
    # carries on each BatchEntry.
    spec_k: int = 0
    # estimator constant overhead is carried by the estimator itself (t_c)


@dataclass
class SchedView:
    queue: list[Request]         # unfinished requests assigned to the engine
    bm: BlockManager
    est: BatchLatencyEstimator
    cfg: EngineConfig
    now: float = 0.0


@dataclass
class BatchEntry:
    req: Request
    n_tokens: int                # tokens computed this pass
    l_kv: int                    # context length already cached before pass
    is_prefill: bool             # chunked-prefill-style pass vs single decode
    depth: int = 0               # speculation depth this pass (decode only)

    def work_item(self):
        return (self.n_tokens, self.l_kv, self.is_prefill)


@dataclass
class BatchPlan:
    entries: list[BatchEntry] = field(default_factory=list)
    evictions: list[Request] = field(default_factory=list)
    est_time: float = 0.0        # estimator's view of batch latency
    t_budget: float = 0.0        # SlideBatching latency budget (0 = n/a)
    copy_blocks: int = 0         # H2D blocks consumed this round
    # SlideBatching, when it admits nothing while requests are queued: why
    # ("budget", "copy", "blocks" or "none_ready"; see slidebatching.py)
    idle_reason: str = ""

    def work_items(self):
        return [e.work_item() for e in self.entries]


class Policy(Protocol):
    name: str
    def form_batch(self, view: SchedView) -> BatchPlan: ...


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def needed_context(req: Request) -> int:
    """KV tokens that must be resident BEFORE the next forward pass.

    * generated == 0 : the remaining prompt is still to be processed; the
      pass that brings residency to ``prompt_len`` emits the first token.
    * generated == g : decoding token g+1 processes token g (writing its KV)
      while attending to the ``prompt_len + g - 1`` previous positions.
    """
    return req.prompt_len + max(0, req.generated - 1)


def compute_remaining(req: Request, bm: BlockManager) -> tuple[int, int]:
    """(tokens still to COMPUTE, resident tokens assumed restorable).

    Host-resident tokens count as restorable (copied, not recomputed);
    anything dropped at eviction shows up as missing and must be recomputed.
    """
    s = bm.state(req)
    resident = s.dev_tokens + s.host_tokens
    todo = max(0, needed_context(req) - resident)
    return todo, resident


def exec_estimate(req: Request, view: SchedView) -> float:
    """``r.exec`` of Alg. 1: estimated core latency to produce the next
    output token (full remaining prefill/recompute + one decode step)."""
    todo, resident = compute_remaining(req, view.bm)
    t = 0.0
    if todo > 0:
        t += view.est.prefill_time(todo, resident)
    if req.generated > 0:
        t += view.est.decode_time(needed_context(req) + 1)
    return max(t, 1e-9)


def next_token_weight(req: Request, cfg: EngineConfig) -> float:
    """w_r(r.len): gain of the next token to be emitted."""
    return (cfg.w_p if req.generated == 0 else cfg.w_d) * req.weight


def max_chunk_for_budget(est: BatchLatencyEstimator, l_kv: int,
                         t_left: float, cap: int) -> tuple[int, float]:
    """GetMaxChunk: largest prefill chunk whose estimated time fits t_left.

    Solves a_p c^2 + (b_p*l_kv + c_p) c <= t_left for c, capped at ``cap``.
    Returns (chunk_tokens, est_time); (0, 0) if even one token won't fit.
    """
    if cap <= 0 or t_left <= 0:
        return 0, 0.0
    if math.isinf(t_left):
        return cap, est.prefill_time(cap, l_kv)
    a = est.a_p
    b = est.b_p * l_kv + est.c_p
    if a <= 0:
        c = cap if b <= 0 else min(cap, int(t_left / b))
    else:
        disc = b * b + 4.0 * a * t_left
        c = min(cap, int((math.sqrt(disc) - b) / (2.0 * a)))
    if c < 1:
        return 0, 0.0
    return c, est.prefill_time(c, l_kv)


def evict_for_space(view: SchedView, need_blocks: int,
                    protect: set[int]) -> list[Request]:
    """§4.3 eviction policy: free blocks by evicting requests near the TAIL
    of the (already sorted) queue, sparing ``protect`` (batch members) and
    requests whose wait is close to the starvation threshold.  Unpinned
    prefix-cache blocks are reclaimed first — they cost no recompute."""
    evicted: list[Request] = []
    if view.bm.free_blocks < need_blocks:
        view.bm.reclaim_cache(need_blocks - view.bm.free_blocks)
    if view.bm.free_blocks >= need_blocks:
        return evicted
    for r in reversed(view.queue):
        if view.bm.free_blocks >= need_blocks:
            break
        if r.rid in protect or r.phase == Phase.FINISHED:
            continue
        wait = view.now - r.arrival
        if r.starving or wait > 0.8 * view.cfg.tau:
            continue
        if view.bm.state(r).dev_tokens > 0:
            view.bm.evict(r, view.now)
            r.preemptions += 1
            evicted.append(r)
    return evicted


def grow_with_eviction(view: SchedView, req: Request, n_tokens: int,
                       protect: set[int],
                       evictions: list[Request]) -> bool:
    """Reserve device blocks for ``n_tokens`` of new KV, evicting if needed."""
    need = view.bm.blocks_needed_for_growth(req, n_tokens)
    if need > view.bm.free_blocks:
        evictions.extend(evict_for_space(view, need, protect))
    if need > view.bm.free_blocks:
        return False
    return view.bm.grow(req, n_tokens, view.now)
