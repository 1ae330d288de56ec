"""Trace-replay load generator: replay any ``sim/workloads.py`` spec in
real or scaled time against the async serving front-end, or in simulated
time against the cluster simulator — reporting the same per-priority
gain / SLO-attainment metrics either way.

This is the bridge between the paper-scale discrete-event experiments and
the live torch engine: the identical request trace (arrivals, lengths,
priorities, SLOs) can be pushed through ``ClusterSim`` (instant, analytic)
and through ``ServiceFrontend`` (wall clock, real continuous batching,
client-edge latency), and the two ``ReplayReport``s compared row-for-row.

Port of ``repro.sim.replay``: the simulated-time paths are copied
verbatim; the frontend mode builds the port's torch ``Engine``s, on the
card unless it is given ``device="cpu"``.

CLI (see docs/WORKLOADS.md for the full schema and report columns):

    PYTHONPATH=src python -m repro_torch.sim.replay --workload shared_prefix \\
        --mode sim --rate 40 --duration 6
    PYTHONPATH=src python -m repro_torch.sim.replay --workload industrial \\
        --mode frontend --speed 200 --replicas 2 [--device cpu]
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from ..core.request import Request, SLO
from .metrics import StreamingSummary, Summary, summarize


@dataclass
class ReplayReport:
    summary: Summary            # client-edge (frontend) or sim-time metrics
    n_submitted: int
    n_completed: int
    n_rejected: int
    wall: float                 # wall-clock seconds the replay took
    speed: float                # trace-time compression factor

    def row(self) -> dict:
        d = {"submitted": self.n_submitted, "completed": self.n_completed,
             "rejected": self.n_rejected, "wall_s": round(self.wall, 3),
             "speed": self.speed}
        d.update(self.summary.row())
        return d

    @property
    def per_priority(self) -> dict:
        return self.summary.per_priority


def clip_lengths(requests: Iterable[Request], *, max_in: int = 64,
                 max_out: int = 8, slo: Optional[SLO] = None,
                 ) -> list[Request]:
    """Shrink a paper-scale trace to something a tiny smoke model can chew
    in seconds, preserving arrivals / priorities / weights / clients and
    the shared-prefix identity (the shared span clips with the prompt)."""
    out = []
    for r in requests:
        prompt_len = min(r.prompt_len, max_in)
        out.append(Request(
            prompt_len=prompt_len,
            output_len=max(1, min(r.output_len, max_out)),
            arrival=r.arrival, slo=slo or r.slo,
            priority=r.priority, weight=r.weight, client=r.client,
            prefix_group=r.prefix_group,
            shared_prefix_len=min(r.shared_prefix_len, prompt_len)))
    return out


def synth_prompt(req: Request, vocab: int, rng: np.random.Generator,
                 seed: int = 0) -> np.ndarray:
    """Token content for a trace request: requests in the same
    ``prefix_group`` get byte-identical shared prefixes (deterministic in
    ``seed``+group), so the engine-side radix cache sees real shared
    content; the suffix is unique per request."""
    n_pre = min(req.shared_prefix_len, req.prompt_len) \
        if req.prefix_group >= 0 else 0
    parts = []
    if n_pre > 0:
        g = np.random.default_rng([seed, req.prefix_group])
        parts.append(g.integers(1, vocab, n_pre))
    if req.prompt_len - n_pre > 0:
        parts.append(rng.integers(1, vocab, req.prompt_len - n_pre))
    return np.concatenate(parts).astype(np.int32)


def smoke_frontend(replicas: int = 2, *, prefix_cache: bool = True,
                   router: str = "gorouting", sched: str = "slidebatching",
                   w_p: float = 4.0, max_inflight: int = 4096,
                   packed_prefill: bool = True,
                   overlap_transfers: bool = True, device="cuda",
                   seed: int = 0):
    """The smoke-scale live serving stack (tiny model, refcounted paged KV,
    radix prefix cache) shared by ``repro_torch.examples.shared_prefix``
    and the CLI below — one definition, so both measure the same
    configuration.  Weights from ``torch.Generator`` seed ``seed`` on
    ``device`` (the card unless ``"cpu"``).  Imports torch lazily; returns
    ``(frontend, model_cfg)``."""
    import torch

    from ..configs import get_smoke
    from ..core import (BatchLatencyEstimator, EngineConfig, GoRouting,
                        MinLoad, RoundRobin, RouterConfig, make_policy)
    from ..models.model import init_params, resolve_device
    from ..serving import Engine, FrontendConfig, ServiceFrontend

    dev = resolve_device(device)
    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                         device=dev)
    est = BatchLatencyEstimator(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8,
                                b_d=1e-3, t_c=1e-2)
    make_router = {"gorouting": lambda: GoRouting(
                       est, RouterConfig(pd_mode="coloc")),
                   "min_load": lambda: MinLoad(est),
                   "round_robin": lambda: RoundRobin()}[router]
    fe = ServiceFrontend(make_router(), est,
                         FrontendConfig(max_inflight=max_inflight))
    for _ in range(replicas):
        fe.add_instance(Engine(
            cfg, params, EngineConfig(eta=1.0, w_p=w_p, tau=1e9),
            make_policy(sched), num_blocks=192, block_size=16,
            max_ctx=256, prefix_cache=prefix_cache,
            packed_prefill=packed_prefill,
            overlap_transfers=overlap_transfers, device=dev))
    return fe, cfg


def smoke_shared_prefix_trace(n: int, max_out: int = 2) -> list[Request]:
    """The canonical smoke-scale shared-prefix trace: 80% of ``n`` streams
    share one of 2 system prompts (32 tokens = 2 KV blocks), clipped to
    smoke-model lengths."""
    from .workloads import shared_prefix
    trace = shared_prefix(rate=n / 2.0, duration=8.0, seed=3, n_groups=2,
                          prefix_len=32, p_shared=0.8)[:n]
    return clip_lengths(trace, max_in=48, max_out=max_out,
                        slo=SLO(ttft=90.0, tpot=15.0))


async def replay_frontend(frontend, requests: Iterable[Request], vocab: int,
                          *, speed: float = 1.0, seed: int = 0,
                          wait: bool = False, slo_scale: float = 1.0,
                          w_p: float = 1.0, w_d: float = 1.0,
                          ) -> ReplayReport:
    """Replay ``requests`` against a started :class:`ServiceFrontend`.

    Arrivals are honoured in wall time compressed by ``speed`` (2.0 = twice
    as fast as the trace).  Each submitted request is consumed by its own
    task so thousands of streams run concurrently; admission rejections
    (``wait=False``) are counted, ``wait=True`` applies backpressure
    instead.  Metrics are CLIENT-EDGE: stamped where the consumer receives
    each token, summarised with ``sim.metrics.summarize``.
    """
    from ..serving.frontend import AdmissionError     # lazy: pulls in torch

    rng = np.random.default_rng(seed)
    reqs = sorted(requests, key=lambda r: r.arrival)
    streams: list = []
    consumers: list[asyncio.Task] = []
    rejected = 0
    t0 = time.monotonic()
    for src in reqs:
        target = t0 + src.arrival / max(speed, 1e-9)
        delay = target - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        req = Request(
            prompt_len=src.prompt_len, output_len=src.output_len,
            arrival=0.0,
            slo=SLO(src.slo.ttft * slo_scale, src.slo.tpot * slo_scale),
            priority=src.priority, weight=src.weight, client=src.client,
            prefix_group=src.prefix_group,
            shared_prefix_len=src.shared_prefix_len)
        prompt = synth_prompt(src, vocab, rng, seed=seed)
        try:
            stream = await frontend.submit(req, prompt, wait=wait)
        except AdmissionError:
            rejected += 1
            continue
        streams.append(stream)
        consumers.append(asyncio.ensure_future(stream.collect()))
    if consumers:
        await asyncio.gather(*consumers, return_exceptions=True)
    wall = time.monotonic() - t0
    clones = [s.as_request() for s in streams]
    return ReplayReport(
        summary=summarize(clones, w_p=w_p, w_d=w_d),
        n_submitted=len(streams),
        n_completed=sum(1 for s in streams if s.complete),
        n_rejected=rejected, wall=wall, speed=speed)


def replay_sim(cluster, requests: list[Request], *, w_p: float = 1.0,
               w_d: float = 1.0) -> ReplayReport:
    """Replay the same trace through a ``ClusterSim`` (simulated time)."""
    t0 = time.monotonic()
    cluster.run(requests)
    wall = time.monotonic() - t0
    done = sum(1 for r in requests if r.finish_time is not None)
    return ReplayReport(
        summary=summarize(requests, w_p=w_p, w_d=w_d),
        n_submitted=len(requests), n_completed=done,
        n_rejected=len(cluster.dropped), wall=wall, speed=float("inf"))


def replay_sim_stream(cluster, requests: Iterable[Request], *,
                      w_p: float = 1.0, w_d: float = 1.0,
                      release: bool = True,
                      bounded: bool = False) -> ReplayReport:
    """``replay_sim`` at 10⁵⁺-request scale: arrivals stream from an
    iterator (sorted by arrival — e.g. ``workloads.iter_scale_trace``) and
    metrics fold incrementally as requests finish, so neither the trace
    nor per-request metric lists are ever fully resident.  With
    ``release`` each finished request's token-timestamp list is freed
    after folding; ``bounded`` swaps exact percentile buffers for the
    bounded-memory sketch (10⁶ scale).  Dropped (router-rejected)
    requests fold in at the end, exactly as ``summarize`` counts them in
    the list path."""
    agg = StreamingSummary(w_p=w_p, w_d=w_d, bounded=bounded)

    def fold(r: Request) -> None:
        agg.add(r)
        if release:
            r.out_times.clear()

    t0 = time.monotonic()
    n = cluster.run_stream(requests, on_finished=fold)
    wall = time.monotonic() - t0
    done = agg.n
    for r in cluster.dropped:
        agg.add(r)
    return ReplayReport(
        summary=agg.summary(), n_submitted=n, n_completed=done,
        n_rejected=len(cluster.dropped), wall=wall, speed=float("inf"))


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _main(argv: Optional[list] = None) -> None:
    import argparse
    import json
    import math

    from .workloads import WORKLOADS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.replay",
        description="Replay a workload trace in simulated time (ClusterSim)"
                    " or scaled wall-clock time (async ServiceFrontend over"
                    " live smoke-scale torch engines).")
    ap.add_argument("--workload", choices=sorted(WORKLOADS),
                    default="sharegpt")
    ap.add_argument("--mode", choices=["sim", "frontend"], default="sim")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="arrivals per second of trace time")
    ap.add_argument("--duration", type=float, default=6.0,
                    help="trace length in seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--router", default="gorouting",
                    choices=["gorouting", "min_load", "round_robin"])
    ap.add_argument("--sched", default="slidebatching")
    ap.add_argument("--w-p", type=float, default=4.0,
                    help="first-token gain weight")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--n-requests", type=int, default=None,
                    help="sim mode: generate exactly N requests at --rate "
                         "via the streaming scale generator "
                         "(iter_scale_trace; --workload/--duration ignored)")
    ap.add_argument("--stream", action="store_true",
                    help="sim mode: constant-memory streaming replay "
                         "(arrivals from an iterator, metrics folded "
                         "incrementally; required for 10⁵⁺ requests)")
    ap.add_argument("--vector", action="store_true",
                    help="sim mode: vectorized scheduler hot path "
                         "(VectorClusterSim — identical per-request "
                         "results, minutes instead of hours at scale)")
    ap.add_argument("--windowed", action="store_true",
                    help="sim mode: windowed cross-replica event loop "
                         "(WindowedClusterSim — bitwise-identical "
                         "results, no global event heap)")
    ap.add_argument("--workers", type=int, default=0,
                    help="sim mode: shard replicas over N forked worker "
                         "processes (stale-view window routing; 0 = "
                         "in-process twin of the same loop)")
    ap.add_argument("--window", type=float, default=None,
                    help="sharded mode window length in trace seconds "
                         "(default: the cluster heartbeat interval)")
    ap.add_argument("--bounded-metrics", action="store_true",
                    help="bounded-memory percentile sketches "
                         "(StreamingSummary(bounded=True); needed at "
                         "10⁶ scale)")
    ap.add_argument("--speed", type=float, default=200.0,
                    help="frontend mode: trace-time compression (200 = "
                         "replay 200x faster than the trace)")
    ap.add_argument("--max-in", type=int, default=48,
                    help="frontend mode: clip prompts to smoke-model size")
    ap.add_argument("--max-out", type=int, default=4,
                    help="frontend mode: clip outputs")
    ap.add_argument("--device", default="cuda",
                    help="frontend mode: where the engines run (the card "
                         "unless 'cpu')")
    args = ap.parse_args(argv)

    from ..core import (EngineConfig, GoRouting, MinLoad, RoundRobin,
                        RouterConfig, make_policy)

    if args.n_requests is not None and args.mode == "sim":
        from .workloads import iter_scale_trace
        reqs = iter_scale_trace(args.n_requests, rate=args.rate,
                                seed=args.seed)
    else:
        reqs = WORKLOADS[args.workload](rate=args.rate,
                                        duration=args.duration,
                                        seed=args.seed)
    if args.mode == "sim":
        from .cluster import ClusterConfig, ClusterSim
        from .executor import (AnalyticalExecutor, InstanceHardware,
                               QWEN2_7B)
        from .vector import VectorClusterSim
        from .windowed import WindowedClusterSim
        ex = AnalyticalExecutor(QWEN2_7B, InstanceHardware(chips=4))
        est, _ = ex.fit_estimator(n=200)

        def make_router():
            return {"gorouting": lambda: GoRouting(
                        est, RouterConfig(pd_mode="coloc")),
                    "min_load": lambda: MinLoad(est),
                    "round_robin": lambda: RoundRobin()}[args.router]()

        sim_cls = (WindowedClusterSim if (args.windowed or args.workers)
                   else VectorClusterSim if args.vector else ClusterSim)
        ccfg = ClusterConfig(pd_mode="coloc", n_prefill=args.replicas,
                             prefix_cache=not args.no_prefix_cache)

        def factory():
            return sim_cls(lambda: make_policy(args.sched), make_router(),
                           ex, est, EngineConfig(w_p=args.w_p), ccfg)

        if args.workers:
            from .shard import replay_sim_sharded
            rep, extras = replay_sim_sharded(
                factory, reqs, workers=args.workers, window=args.window,
                w_p=args.w_p, bounded=args.bounded_metrics)
            extra = {"prefill_tokens": extras["counters"]["prefill_tokens"],
                     "windows": extras["windows"],
                     "workers": extras["workers"]}
        else:
            cs = factory()
            if args.stream:
                rep = replay_sim_stream(cs, reqs, w_p=args.w_p)
            else:
                rep = replay_sim(cs, list(reqs), w_p=args.w_p)
            extra = {"prefill_tokens": sum(e.prefill_tokens
                                           for e in cs.engines.values())}
    else:
        fe, cfg = smoke_frontend(args.replicas,
                                 prefix_cache=not args.no_prefix_cache,
                                 router=args.router, sched=args.sched,
                                 w_p=args.w_p, device=args.device)
        trace = clip_lengths(reqs, max_in=args.max_in, max_out=args.max_out,
                             slo=SLO(ttft=90.0, tpot=15.0))

        async def go():
            await fe.start()
            try:
                return await replay_frontend(fe, trace, cfg.vocab,
                                             speed=args.speed, w_p=args.w_p)
            finally:
                await fe.stop()

        rep = asyncio.run(go())
        engines = list(fe.engines.values())
        extra = {"prefill_tokens": sum(e.stats.prefill_tokens
                                       for e in engines),
                 "cache_hit_tokens": sum(e.stats.cache_hit_tokens
                                         for e in engines)}
    row = {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
           for k, v in {**rep.row(), **extra}.items()}  # inf -> valid JSON
    print(json.dumps(row, indent=1))


if __name__ == "__main__":
    _main()
