"""Serve multi-priority requests on one model replica — the port's entry
point (counterpart of ``repro.launch.serve`` in its ``real`` and ``sim``
modes, ``examples/priority_serving.py`` and ``examples/serve_cluster.py``).

    python -m repro_torch.launch.serve --arch qwen1_5_0_5b
    python -m repro_torch.launch.serve --arch qwen1_5_0_5b --smoke --device cpu
    python -m repro_torch.launch.serve --arch olmoe_1b_7b_0924  # OLMoE as
                                                        # published
    python -m repro_torch.launch.serve --tiered             # bounded host tier
    python -m repro_torch.launch.serve --tiered --exact-cold  # fp32 cold tier
    python -m repro_torch.launch.serve --spec-k 2           # speculative
    python -m repro_torch.launch.serve --spec-k 2 --draft other
    python -m repro_torch.launch.serve --per-request        # fallback paths
    python -m repro_torch.launch.serve --pd disagg --instances 1 \
        --decode-instances 1 [--handoff-int8]              # P/D fleet
    python -m repro_torch.launch.serve --pd coloc --instances 2
    python -m repro_torch.launch.serve --mode frontend --instances 2
    python -m repro_torch.launch.serve --mode frontend --pd disagg \
        --instances 1 --decode-instances 2                 # async P/D
    python -m repro_torch.launch.serve --mode sim --dataset industrial \
        --rate 120 [--hardware h100 --model qwen1.5-0.5b]  # simulator

Random weights from ``--seed`` (nothing is downloaded).  Requests arrive in
two waves: the first fills the paged pool with mid- and low-priority
work; as soon as a first-wave request that shares the common prompt
prefix has its first token, high-priority requests arrive, some with the
same prefix (prefix-cache hits), and the pool is small enough that
serving them preempts (evicts to host, later reloads or recomputes)
lower-priority requests.  Prints the engine
statistics, TTFT/TPOT per priority and TDG_Ratio.  On the card every
attention call runs the hand-written CUDA kernels; ``--device cpu`` runs
their plain PyTorch versions.

The engine copies KV between the card and the host on its background
transfer lanes (``--no-overlap``: synchronously).  ``--tiered`` serves
the ``TIERED`` traffic: longer outputs, so that preempted requests hold
mirrored blocks, and a host tier of ``host_tier_blocks`` blocks, so that
host-tier groups demote into the int8 cold tier (``--exact-cold``: a raw
fp32 cold tier) and prefix-cache evictions spill into the host tiers.
``--host-tier-blocks N`` bounds the host tier of any traffic.

``--spec-k K`` decodes speculatively: a draft model proposes up to K
tokens per request and the target verifies them in one packed launch; the
draft is the target's own weights (``--draft same``, every proposal should
be accepted) or weights from another seed (``--draft other``, most are
rejected).  ``--per-request`` runs the reference's fallback paths: one
``prefill_chunk`` call per prefill chunk and the logits decode
(``packed_prefill=False, fused_decode=False``).

``--pd disagg --instances P --decode-instances D`` serves the same waves
through a fleet: one ``ServiceController`` with GoRouting
(``RouterConfig(pd_mode="disagg")``) over P prefill-role and D
decode-role engines that share one params dict.  Each request prefills on
a prefill replica, its KV crosses to the decode replica reserved for it
at admission (D2H on the prefill replica's lane, a host payload, one
upload and scatter on the decode replica; ``--handoff-int8``: quantized
on the card before the copy, dequantized on the card at adoption), and
decodes there.  ``--pd coloc --instances N`` runs N colocated replicas
under the same controller.  The summary then adds the handoff counters
and the router book's reservation counters.

``--mode frontend`` replays ``REPLAY`` (``--smoke``: ``REPLAY_SMOKE``), the
first 64 requests of the industrial trace (three priority classes), through
the async ``ServiceFrontend`` over ``--instances`` replicas (``--pd
disagg``: prefill replicas plus ``--decode-instances`` decode replicas),
each on its own ``EngineDriver`` thread, at 1000 times the trace's pace;
prompts are clipped to 512 tokens and outputs to 16, with the SLOs of
``PRIORITIES``; the handoff crosses in fp32
(no ``--handoff-int8``).  Other traces and shapes replay through
``python -m repro_torch.sim.replay --mode frontend``.  It prints one JSON
line with client-edge TTFT / TPOT per priority, SLO attainment, TDG_Ratio
and the per-replica iteration counts.  ``--mode sim`` runs the reference
launcher's simulated cell (``launch/multi_node.py``); ``--hardware h100``
prices batches on H100 SXM cards.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs import get, get_smoke
from ..core import (SLO, EngineConfig, GoRouting, Request, RouterConfig,
                    make_policy)
from ..core.estimator import BatchLatencyEstimator
from ..core.tdg import tdg_ratio
from ..models.model import ArchConfig, init_params, resolve_device
from ..serving.engine import Engine
from ..serving.frontend import FrontendConfig, ServiceFrontend
from ..serving.service import ServiceController
from ..sim.replay import clip_lengths, replay_frontend, synth_prompt
from ..sim.workloads import WORKLOADS

# priority -> (weight, TTFT SLO s, TPOT SLO s)
PRIORITIES = {1: (3.0, 0.5, 0.05), 2: (2.0, 1.0, 0.1), 3: (1.0, 2.0, 0.2)}
W_P = 4.0
DRAFT_SEED = 7      # --draft other: weights from seed + DRAFT_SEED
# the fleet router's latency model (GoRouting's EstimateExec); each engine
# keeps its own, refit online
ROUTER_EST = dict(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8, b_d=1e-3,
                  t_c=1e-2)


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Shape of one serve run.  ``num_blocks`` is the pool size in blocks
    of ``block_size`` tokens (block 0 is reserved)."""
    n_first: int = 8              # first wave: priorities 2 and 3
    n_second: int = 4             # second wave: priority 1
    prompt_min: int = 64
    prompt_max: int = 512
    output_len: int = 16
    prefix_len: int = 64          # shared prompt prefix
    num_blocks: int = 160
    block_size: int = 16
    host_tier_blocks: Optional[int] = None   # None: unbounded host tier
    max_seqs: int = EngineConfig.max_seqs    # requests per batch
    n_repeat: int = 0             # third wave: earlier prompts resent


FULL = Traffic()
SMOKE = Traffic(prompt_min=16, prompt_max=96, output_len=8, prefix_len=32,
                num_blocks=28)
# The tiered runs cap the batch at 6 requests, so that requests preempted
# beyond the cap keep their host copies into the next step and reload, and
# resend every earlier prompt once both waves are done, so that the prefix
# cache's spilled nodes are matched and restored.
TIERED = dataclasses.replace(FULL, output_len=48, host_tier_blocks=8,
                             max_seqs=6, n_repeat=12)
TIERED_SMOKE = dataclasses.replace(SMOKE, output_len=24, host_tier_blocks=4,
                                   max_seqs=6, n_repeat=12)


def _summary(engines: list, reqs: list, wall_s: float, arrived: dict,
             emitted: dict) -> dict:
    """Counters summed over ``engines`` (gauges too; ``t_block_measured``
    is the largest), TTFT/TPOT p50 per priority and TDG_Ratio."""
    stats = [e.stats for e in engines]
    tiers = [e.pool.tier for e in engines]

    def total(key):
        return sum(getattr(st, key) for st in stats)

    hist: dict = {}
    for st in stats:
        for d, n in st.spec_depth_hist.items():
            hist[d] = hist.get(d, 0) + n
    tokens_out, prefill_tokens = total("tokens_out"), total("prefill_tokens")
    out = {
        "requests": len(reqs), "tokens_out": tokens_out,
        "prefill_tokens": prefill_tokens, "wall_s": wall_s,
        "tokens_per_s": (tokens_out + prefill_tokens) / wall_s,
        "output_tokens_per_s": tokens_out / wall_s,
        **{k: total(k) for k in (
            "iterations", "evictions", "reload_blocks", "cache_hit_tokens",
            "cache_insert_blocks", "cow_forks", "decode_launches",
            "decode_graph_captures", "decode_graph_replays",
            "packed_prefill_calls", "host_syncs", "prefill_chunk_calls",
            "spec_proposed", "spec_accepted", "spec_rejected",
            "draft_launches", "moe_routed_slots", "moe_expert_rows",
            "moe_dropped_slots")},
        "spec_depth_hist": dict(sorted(hist.items())),
        **{k: total(k) for k in (
            "offload_blocks", "staged_hits", "staged_misses",
            "transfer_failures")},
        "t_block_measured": max(st.t_block_measured for st in stats),
        **{k: total(k) for k in ("host_bytes", "spill_blocks",
                                 "cold_blocks")},
        "demoted_blocks": sum(t.demoted_blocks for t in tiers),
        "cold_reload_blocks": sum(t.cold_reload_blocks for t in tiers),
        "preemptions": sum(r.preemptions for r in reqs),
        "tdg_ratio": tdg_ratio(reqs, w_p=W_P),
    }
    for p in sorted({r.priority for r in reqs}):
        mine = [r.rid for r in reqs if r.priority == p]
        ttft = [emitted[i][0] - arrived[i] for i in mine]
        tpot = [(emitted[i][-1] - emitted[i][0]) / (len(emitted[i]) - 1)
                for i in mine if len(emitted[i]) > 1]
        out[f"ttft_p50_s_prio{p}"] = float(np.median(ttft))
        out[f"tpot_p50_s_prio{p}"] = (float(np.median(tpot)) if tpot
                                      else None)
    return out


@dataclasses.dataclass
class ServeResult:
    cfg: ArchConfig
    params: dict
    engine: Engine
    requests: list                 # [(Request, prompt np.ndarray)]
    wall_s: float
    # host-clock stamps (s since the run began) of each request's arrival
    # and emitted tokens, taken after the launch that produced them
    arrived: dict
    emitted: dict

    @property
    def replicas(self) -> list:
        return [self.engine]

    @property
    def outputs(self) -> dict:
        return self.engine.outputs

    def summary(self) -> dict:
        return _summary([self.engine], [r for r, _ in self.requests],
                        self.wall_s, self.arrived, self.emitted)


@dataclasses.dataclass
class FleetResult:
    cfg: ArchConfig
    params: dict
    controller: ServiceController
    engines: dict                  # iid -> Engine, every replica started
    requests: list                 # [(Request, prompt np.ndarray)]
    wall_s: float
    arrived: dict
    emitted: dict

    @property
    def replicas(self) -> list:
        return list(self.engines.values())

    @property
    def outputs(self) -> dict:
        """rid -> stream, read from the replicas alive at the end (a
        killed replica's partial streams were resumed elsewhere)."""
        out: dict = {}
        for eng in self.controller.engines.values():
            out.update(eng.outputs)
        return out

    def summary(self) -> dict:
        out = _summary(self.replicas, [r for r, _ in self.requests],
                       self.wall_s, self.arrived, self.emitted)
        book = self.controller.book
        out["instances"] = {iid: e.role for iid, e in self.engines.items()}
        out["killed"] = sorted(set(self.engines)
                               - set(self.controller.engines))
        for key in ("handoffs_out", "handoff_blocks_out",
                    "handoff_bytes_out", "handoffs_in", "handoff_blocks_in",
                    "handoff_bytes_in", "handoff_copy_s"):
            out[key] = sum(getattr(e.stats, key) for e in self.replicas)
        for key in ("handoffs", "handoff_blocks", "handoff_bytes",
                    "reservation_hits", "reservation_misses",
                    "reserved_blocks_total", "adopted_blocks_total"):
            out[key] = getattr(book, key)
        return out


def make_requests(cfg: ArchConfig, traffic: Traffic,
                  rng: np.random.Generator) -> tuple[list, list, list]:
    """Three waves of (Request, prompt).  Every other first-wave request
    and the first half of the second wave start with one shared prefix;
    the third wave resends the first ``n_repeat`` prompts of the first two
    waves, at their priorities."""
    prefix = rng.integers(1, cfg.vocab, traffic.prefix_len).astype(np.int32)

    def one(i: int, prio: int, shared: bool):
        weight, ttft, tpot = PRIORITIES[prio]
        plen = int(rng.integers(traffic.prompt_min, traffic.prompt_max + 1))
        if shared:
            plen = max(plen, traffic.prefix_len + traffic.block_size)
        prompt = rng.integers(1, cfg.vocab, plen).astype(np.int32)
        if shared:
            prompt[:traffic.prefix_len] = prefix
        r = Request(prompt_len=plen, output_len=traffic.output_len,
                    arrival=0.0, slo=SLO(ttft, tpot), priority=prio,
                    weight=weight)
        return r, prompt

    first = [one(i, 2 + i % 2, i % 2 == 0) for i in range(traffic.n_first)]
    second = [one(i, 1, i < traffic.n_second // 2 + traffic.n_second % 2)
              for i in range(traffic.n_second)]
    third = []
    for r, prompt in (first + second)[:traffic.n_repeat]:
        weight, ttft, tpot = PRIORITIES[r.priority]
        third.append((Request(prompt_len=r.prompt_len,
                              output_len=traffic.output_len, arrival=0.0,
                              slo=SLO(ttft, tpot), priority=r.priority,
                              weight=weight), prompt))
    return first, second, third


def block_bytes(cfg: ArchConfig, traffic: Traffic, dtype) -> int:
    """Bytes of one KV block (all layers, K and V) in the pool's dtype."""
    return (cfg.n_layers * 2 * traffic.block_size * cfg.n_kv_heads * cfg.hd
            * torch.empty((), dtype=dtype).element_size())


def host_tier_bytes(cfg: ArchConfig, params: dict,
                    traffic: Traffic) -> Optional[int]:
    """The host tier's byte budget (None: unbounded)."""
    if traffic.host_tier_blocks is None:
        return None
    return traffic.host_tier_blocks * block_bytes(cfg, traffic,
                                                  params["embed"].dtype)


def drain(eng: Engine, max_iters: int) -> int:
    """Step until every request is done; returns the steps taken.  Unlike
    ``Engine.run_until_drained``, which stops at the first step that forms
    no batch (as the reference does), one such idle step is retried: its
    planned evictions can release prefix-cache pins, so that the next
    step schedules (the tiered traffic's twelve simultaneous arrivals need
    this).  Two idle steps in a row mean nothing is schedulable."""
    idle = 0
    for it in range(max_iters):
        if not eng.has_work():
            return it
        if eng.step() is None:
            idle += 1
            if idle == 2:
                return it + 1
        else:
            idle = 0
    return max_iters


def serve(cfg: ArchConfig, params: dict, traffic: Traffic, *,
          seed: int = 0, device="cuda", max_iters: int = 10000,
          overlap_transfers: bool = True, cold_quantize: bool = True,
          spec_k: int = 0, draft: Optional[tuple] = None,
          packed_prefill: bool = True,
          fused_decode: bool = True) -> ServeResult:
    """Run the waves through one ``Engine`` until every request is done,
    then wait for the background copies to land.  ``spec_k > 0`` needs
    ``draft = (draft cfg, draft params)``."""
    tier_bytes = host_tier_bytes(cfg, params, traffic)
    eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=W_P, tau=1e9,
                                           max_seqs=traffic.max_seqs,
                                           spec_k=spec_k),
                 make_policy("slidebatching"), num_blocks=traffic.num_blocks,
                 block_size=traffic.block_size, device=device,
                 overlap_transfers=overlap_transfers,
                 host_tier_bytes=tier_bytes, cold_quantize=cold_quantize,
                 spec_draft=draft, packed_prefill=packed_prefill,
                 fused_decode=fused_decode)
    first, second, third = make_requests(cfg, traffic,
                                         np.random.default_rng(seed))
    arrived: dict[int, float] = {}
    emitted: dict[int, list] = {}
    t0 = time.monotonic()

    def on_token(req, tok, first_tok, last):
        emitted.setdefault(req.rid, []).append(time.monotonic() - t0)

    eng.on_token = on_token
    for r, p in first:
        arrived[r.rid] = 0.0
        eng.add_request(r, p)
    # the second wave arrives right after the step in which the first
    # prefix-sharing request of the first wave got its first token: its
    # prompt blocks are in the prefix cache, pinned while it runs
    sharers = [r for r, p in first[::2]]
    it = 0
    while it < max_iters and not any(r.generated for r in sharers):
        if eng.step() is None:
            break
        it += 1
    for wave in (second, third):
        for r, p in wave:
            r.arrival = eng.now
            arrived[r.rid] = time.monotonic() - t0
            eng.add_request(r, p)
        # the third wave arrives once the first two are done
        it += drain(eng, max_iters - it)
    eng.flush_transfers()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    unfinished = [r.rid for r, _ in first + second + third
                  if r.generated < r.output_len]
    if unfinished:
        raise RuntimeError(f"requests {unfinished} did not finish")
    return ServeResult(cfg, params, eng, first + second + third, wall,
                       arrived, emitted)


def drain_fleet(ctl: ServiceController, max_rounds: int,
                after_round: Optional[Callable] = None) -> int:
    """``step_all`` until no replica has work; returns the rounds taken.
    A round in which no replica stepped, exported or adopted first waits
    for the replicas' transfer lanes (a handoff copy may be in flight);
    two such rounds in a row mean nothing is schedulable."""
    def progress():
        return sum(e.stats.iterations + e.stats.handoffs_out
                   + e.stats.handoffs_in for e in ctl.engines.values())

    idle = 0
    for rnd in range(max_rounds):
        if not any(e.has_work() for e in ctl.engines.values()):
            return rnd
        before = progress()
        ctl.step_all()
        if after_round is not None:
            after_round(ctl)
        if progress() == before:
            idle += 1
            if idle == 2:
                return rnd + 1
            for e in ctl.engines.values():
                if e.worker is not None:
                    e.worker.flush()
        else:
            idle = 0
    return max_rounds


def serve_fleet(cfg: ArchConfig, params: dict, traffic: Traffic, *,
                roles: Sequence[str], pd_mode: str, seed: int = 0,
                device="cuda", max_rounds: int = 10000,
                overlap_transfers: bool = True, cold_quantize: bool = True,
                handoff_int8: bool = False,
                after_round: Optional[Callable] = None) -> FleetResult:
    """Run the waves through a ``ServiceController`` over one engine per
    entry of ``roles`` (``"coloc"``, ``"prefill"``, ``"decode"``), all
    sharing ``params``, routed by GoRouting with ``pd_mode`` (``"coloc"``
    or ``"disagg"``).  ``after_round(controller)`` runs after each round
    (a churn drill kills replicas there).  The second wave arrives after
    the round in which the first prefix-sharing request of the first
    wave got its first token.  The replicas share one wall clock, so a
    request's token stamps stay ordered when it moves between them."""
    tier_bytes = host_tier_bytes(cfg, params, traffic)
    est = BatchLatencyEstimator(**ROUTER_EST)
    ctl = ServiceController(GoRouting(est, RouterConfig(pd_mode=pd_mode)),
                            est)
    first, second, third = make_requests(cfg, traffic,
                                         np.random.default_rng(seed))
    arrived: dict[int, float] = {}
    emitted: dict[int, list] = {}
    t0 = time.monotonic()

    def on_token(req, tok, first_tok, last):
        emitted.setdefault(req.rid, []).append(time.monotonic() - t0)

    engines = {}
    for role in roles:
        eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=W_P, tau=1e9,
                                               max_seqs=traffic.max_seqs),
                     make_policy("slidebatching"),
                     num_blocks=traffic.num_blocks,
                     block_size=traffic.block_size, device=device,
                     overlap_transfers=overlap_transfers,
                     host_tier_bytes=tier_bytes,
                     cold_quantize=cold_quantize, role=role,
                     handoff_quantize=handoff_int8)
        eng.on_token = on_token
        eng.use_wall_clock(t0)
        engines[ctl.add_instance(eng)] = eng
    for r, p in first:
        arrived[r.rid] = 0.0
        ctl.submit(r, p)
    sharers = [r for r, p in first[::2]]
    rounds = 0
    while rounds < max_rounds and not any(r.generated for r in sharers):
        if drain_fleet(ctl, 1, after_round) == 0:
            break
        rounds += 1
    for wave in (second, third):
        for r, p in wave:
            r.arrival = arrived[r.rid] = time.monotonic() - t0
            ctl.submit(r, p)
        rounds += drain_fleet(ctl, max_rounds - rounds, after_round)
    for eng in ctl.engines.values():
        eng.flush_transfers()
    if any(e.device.type == "cuda" for e in engines.values()):
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    unfinished = [r.rid for r, _ in first + second + third
                  if r.generated < r.output_len]
    if unfinished:
        raise RuntimeError(f"requests {unfinished} did not finish")
    return FleetResult(cfg, params, ctl, engines, first + second + third,
                       wall, arrived, emitted)


@dataclasses.dataclass(frozen=True)
class Replay:
    """Shape of one frontend replay: the first ``n_requests`` of a
    ``workload`` trace (``rate = n_requests / 2`` over 8 s from
    ``trace_seed``, as ``examples/serve_cluster.py`` draws it), prompts
    clipped to ``max_in`` and outputs to ``max_out`` tokens, the SLOs of
    ``PRIORITIES``, replayed at ``speed`` times the trace's pace (1000:
    every request in flight together) over replicas of ``num_blocks``
    blocks."""
    workload: str = "industrial"
    n_requests: int = 64
    max_in: int = 512
    max_out: int = 16
    speed: float = 1000.0
    num_blocks: int = 160
    block_size: int = 16
    trace_seed: int = 1


REPLAY = Replay()
DRAIN_TIMEOUT_S = 600.0
REPLAY_SMOKE = Replay(n_requests=16, max_in=96, max_out=8, num_blocks=28)


def replay_trace(replay: Replay) -> list:
    """The replay's requests in arrival order, clipped, with the SLOs of
    ``PRIORITIES``."""
    n = replay.n_requests
    trace = WORKLOADS[replay.workload](rate=n / 2.0, duration=8.0,
                                       seed=replay.trace_seed)[:n]
    trace = clip_lengths(trace, max_in=replay.max_in,
                         max_out=replay.max_out)
    for r in trace:
        r.slo = SLO(*PRIORITIES[r.priority][1:])
    return sorted(trace, key=lambda r: r.arrival)


@dataclasses.dataclass
class FrontendResult:
    cfg: ArchConfig
    params: dict
    frontend: ServiceFrontend
    engines: dict                  # iid -> Engine, every replica started
    requests: list                 # [(Request, prompt np.ndarray)]
    streams: list                  # RequestStream per request, same order
    report: object                 # sim.replay.ReplayReport (client edge)
    drained: bool                  # frontend.drain() returned True
    orphans: list                  # requests re-dispatched by a kill

    @property
    def replicas(self) -> list:
        return list(self.engines.values())

    @property
    def wall_s(self) -> float:
        return self.report.wall

    @property
    def outputs(self) -> dict:
        """rid -> the tokens its client received."""
        return {s.request.rid: list(s.tokens) for s in self.streams}

    def summary(self) -> dict:
        """``examples/serve_cluster.py``'s report as one dict: the replay
        row (client-edge TDG_Ratio, SLO attainment, TTFT / TPOT), TTFT and
        TPOT p50 / p99 per priority at the client edge, each replica's
        iterations, tokens and speed EWMA, and the counters summed over
        the replicas (killed ones too)."""
        out = dict(self.report.row())
        for p in sorted({s.request.priority for s in self.streams}):
            mine = [s for s in self.streams if s.request.priority == p]
            for key in ("ttft", "tpot"):
                vals = [getattr(s, key) for s in mine
                        if getattr(s, key) is not None]
                for q in (50, 99):
                    out[f"{key}_p{q}_s_prio{p}"] = (
                        float(np.percentile(vals, q)) if vals else None)
        book = self.frontend.book
        out["replicas"] = {
            iid: {"role": e.role, "iterations": e.stats.iterations,
                  "tokens_out": e.stats.tokens_out,
                  "speed_ewma": (book.states[iid].speed
                                 if iid in book.states else None)}
            for iid, e in self.engines.items()}
        out["killed"] = sorted(self.frontend.killed)
        out["orphans"] = len(self.orphans)
        for key in ("iterations", "tokens_out", "prefill_tokens",
                    "evictions", "reload_blocks", "cache_hit_tokens",
                    "decode_launches", "decode_graph_captures",
                    "decode_graph_replays", "packed_prefill_calls",
                    "host_syncs", "offload_blocks", "transfer_failures",
                    "handoffs_out",
                    "handoff_blocks_out", "handoff_bytes_out", "handoffs_in",
                    "handoff_blocks_in", "handoff_bytes_in", "d2h_copy_s",
                    "d2h_copy_blocks", "h2d_copy_s", "h2d_copy_blocks",
                    "moe_routed_slots", "moe_expert_rows",
                    "moe_dropped_slots"):
            out[key] = sum(getattr(e.stats, key) for e in self.replicas)
        out["busy_s"] = {iid: e.stats.busy_s
                         for iid, e in self.engines.items()}
        for key in ("handoffs", "handoff_blocks", "handoff_bytes",
                    "reservation_hits", "reservation_misses",
                    "reserved_blocks_total", "adopted_blocks_total"):
            out[key] = getattr(book, key)
        out["drained"] = self.drained
        return out


async def _kill_after_first_token(fe: ServiceFrontend, iid: int,
                                  orphans: list) -> None:
    eng = fe.drivers[iid].engine
    while eng.stats.tokens_out == 0:
        await asyncio.sleep(1e-3)
    orphans.extend(fe.kill_instance(iid))


def serve_frontend(cfg: ArchConfig, params: dict, replay: Replay, *,
                   roles: Sequence[str], pd_mode: str, seed: int = 0,
                   device="cuda",
                   est: Optional[BatchLatencyEstimator] = None,
                   kill: Optional[int] = None) -> FrontendResult:
    """Replay ``replay``'s trace through a ``ServiceFrontend`` over one
    engine per entry of ``roles`` (sharing ``params``), routed by GoRouting
    with ``pd_mode``; ``est`` is the router's and the book's latency model
    (default ``ROUTER_EST``).  ``kill``: the replica killed with
    ``kill_instance`` once it has emitted a token.  Raises
    ``DriverDied`` if a driver thread raised."""
    est = est or BatchLatencyEstimator(**ROUTER_EST)
    fe = ServiceFrontend(GoRouting(est, RouterConfig(pd_mode=pd_mode)), est,
                         FrontendConfig(max_inflight=max(replay.n_requests,
                                                         64)))
    engines = {}
    for role in roles:
        eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=W_P, tau=1e9),
                     make_policy("slidebatching"),
                     num_blocks=replay.num_blocks,
                     block_size=replay.block_size, device=device, role=role)
        engines[fe.add_instance(eng)] = eng
    trace = replay_trace(replay)
    # the prompts replay_frontend draws: one generator, in arrival order
    rng = np.random.default_rng(seed)
    prompts = [synth_prompt(src, cfg.vocab, rng, seed=seed) for src in trace]
    orphans: list = []

    async def go():
        await fe.start()
        try:
            killer = (asyncio.ensure_future(
                _kill_after_first_token(fe, kill, orphans))
                if kill is not None else None)
            rep = await replay_frontend(fe, trace, cfg.vocab,
                                        speed=replay.speed, seed=seed,
                                        w_p=W_P)
            drained = await fe.drain(DRAIN_TIMEOUT_S)
            if killer is not None:
                if killer.done():
                    killer.result()       # raises what the kill raised
                else:
                    killer.cancel()       # the replica never emitted
            # streams still open (drained False) are dropped by stop()
            with fe._lock:
                unfinished = list(fe._streams.values())
        finally:
            await fe.stop()
        return rep, drained, unfinished

    rep, drained, unfinished = asyncio.run(go())
    if any(e.device.type == "cuda" for e in engines.values()):
        torch.cuda.synchronize()
    if rep.n_rejected or rep.n_submitted != len(trace):
        raise RuntimeError(f"{rep.n_rejected} of {len(trace)} requests "
                           "rejected at admission")
    # rids grow in submission order, which is the prompts' (arrival) order
    streams = sorted(fe.completed_streams + unfinished,
                     key=lambda s: s.request.rid)
    return FrontendResult(cfg, params, fe, engines,
                          [(s.request, p) for s, p in zip(streams, prompts)],
                          streams, rep, drained, orphans)


def main(argv: Optional[list[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("real", "frontend", "sim"),
                    default="real",
                    help="real: the engine (or a --pd fleet under the "
                         "synchronous controller); frontend: a trace "
                         "replayed through the async ServiceFrontend; sim: "
                         "the cluster simulator")
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model and traffic (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiered", action="store_true",
                    help="the TIERED traffic: bounded host tier, int8 cold "
                         "tier, prefix-cache spill")
    ap.add_argument("--host-tier-blocks", type=int, default=None,
                    help="bound the host tier to N KV blocks")
    ap.add_argument("--exact-cold", action="store_true",
                    help="keep the cold tier in fp32 (cold_quantize=False)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="copy KV synchronously instead of on the "
                         "background transfer lanes")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative decoding with draft depth up to K")
    ap.add_argument("--draft", choices=("same", "other"), default=None,
                    help="the draft's weights: the target's (same, the "
                         "default) or from another seed (other)")
    ap.add_argument("--per-request", action="store_true",
                    help="per-request prefill chunks and the logits decode "
                         "(packed_prefill=False, fused_decode=False)")
    ap.add_argument("--pd", choices=("coloc", "disagg"), default=None,
                    help="serve through a fleet of replicas under the "
                         "service controller: colocated, or split into "
                         "prefill and decode roles")
    ap.add_argument("--instances", type=int, default=None, metavar="N",
                    help="--pd coloc: replicas; --pd disagg: prefill "
                         "replicas (default 1; --mode frontend: 2; --mode "
                         "sim: 4)")
    ap.add_argument("--decode-instances", type=int, default=None,
                    metavar="D", help="--pd disagg: decode replicas "
                                      "(default 1)")
    ap.add_argument("--handoff-int8", action="store_true",
                    help="--pd disagg: quantize the handoff's KV to int8 "
                         "on the card (not with --mode frontend)")
    ap.add_argument("--dataset", default="sharegpt",
                    help="--mode sim: the workload")
    ap.add_argument("--rate", type=float, default=80.0,
                    help="--mode sim: arrivals per second")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="--mode sim: trace length in seconds")
    ap.add_argument("--sched", default="slidebatching",
                    help="--mode sim: the scheduler")
    ap.add_argument("--router", default="gorouting",
                    help="--mode sim: the router")
    ap.add_argument("--model", default="qwen2-7b",
                    help="--mode sim: qwen2-7b, qwen3-32b or qwen1.5-0.5b")
    ap.add_argument("--hardware", choices=("v5e", "h100"), default="v5e",
                    help="--mode sim: the executor's chip (v5e: the "
                         "reference's instance)")
    args = ap.parse_args(argv)
    if args.mode == "sim":
        return _main_sim(args)
    if args.instances is None:
        args.instances = 2 if args.mode == "frontend" else 1
    if args.mode == "frontend":
        return _main_frontend(ap, args)
    if args.draft is not None and args.spec_k <= 0:
        ap.error("--draft needs --spec-k K > 0")
    if args.pd is None and (args.instances != 1 or args.handoff_int8
                            or args.decode_instances is not None):
        ap.error("--instances, --decode-instances and --handoff-int8 need "
                 "--pd")
    if args.pd is not None and (args.spec_k or args.per_request):
        ap.error("--pd serves with packed prefill and plain decode")
    if args.pd == "coloc" and (args.decode_instances or args.handoff_int8):
        ap.error("--decode-instances and --handoff-int8 need --pd disagg")
    n_decode = (args.decode_instances if args.decode_instances is not None
                else 1)
    if args.instances < 1 or (args.pd == "disagg" and n_decode < 1):
        ap.error("a fleet needs at least one replica of each role")

    dev = resolve_device(args.device)
    # fp32 is the parity mode: full-precision matmuls, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if args.tiered:
        traffic = TIERED_SMOKE if args.smoke else TIERED
    else:
        traffic = SMOKE if args.smoke else FULL
    if args.host_tier_blocks is not None:
        traffic = dataclasses.replace(traffic,
                                      host_tier_blocks=args.host_tier_blocks)
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    if args.pd is not None:
        roles = (["coloc"] * args.instances if args.pd == "coloc" else
                 ["prefill"] * args.instances + ["decode"] * n_decode)
        fleet = serve_fleet(cfg, params, traffic, roles=roles,
                            pd_mode=args.pd, seed=args.seed, device=dev,
                            overlap_transfers=not args.no_overlap,
                            cold_quantize=not args.exact_cold,
                            handoff_int8=args.handoff_int8)
        print(json.dumps({"arch": cfg.name, "device": where, "pd": args.pd,
                          **fleet.summary()}))
        return fleet
    draft = None
    if args.spec_k > 0:
        draft = (cfg, params if args.draft in (None, "same") else init_params(
            cfg, torch.Generator(dev).manual_seed(args.seed + DRAFT_SEED),
            device=dev))
    res = serve(cfg, params, traffic, seed=args.seed, device=dev,
                overlap_transfers=not args.no_overlap,
                cold_quantize=not args.exact_cold, spec_k=args.spec_k,
                draft=draft, packed_prefill=not args.per_request,
                fused_decode=not args.per_request)
    print(json.dumps({"arch": cfg.name, "device": where,
                      **res.summary()}))
    return res


def _main_sim(args):
    from .multi_node import run_multi_node
    row, _ = run_multi_node(
        args.dataset, args.rate, args.sched, args.router,
        pd_mode=args.pd or "coloc",
        n_prefill=4 if args.instances is None else args.instances,
        n_decode=args.decode_instances or 0, model=args.model,
        duration=args.duration, seed=args.seed, hardware=args.hardware)
    print(json.dumps(row, indent=1))
    return row


def _main_frontend(ap, args):
    if args.spec_k or args.per_request or args.tiered or args.no_overlap:
        ap.error("--mode frontend serves with packed prefill, plain decode "
                 "and the transfer lanes")
    if args.handoff_int8:
        ap.error("--mode frontend hands KV off in fp32")
    if args.pd != "disagg" and args.decode_instances:
        ap.error("--decode-instances needs --pd disagg")
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    replay = REPLAY_SMOKE if args.smoke else REPLAY
    pd = args.pd or "coloc"
    roles = (["coloc"] * args.instances if pd == "coloc" else
             ["prefill"] * args.instances
             + ["decode"] * (args.decode_instances or 1))
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    res = serve_frontend(cfg, params, replay, roles=roles, pd_mode=pd,
                         seed=args.seed, device=dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(json.dumps({"arch": cfg.name, "device": where, "mode": "frontend",
                      "pd": pd, "workload": replay.workload,
                      **res.summary()}))
    for eng in res.replicas:
        eng.kill()
    return res


if __name__ == "__main__":
    main()
