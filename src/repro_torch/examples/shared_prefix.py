"""Shared-prefix serving demo (port of ``examples/shared_prefix.py``): many
streams sharing a common system prompt, served by torch engine replicas
with the radix prefix cache ON vs OFF.

With the cache on, only the first request of each prefix group prefills the
shared span; every later request points its block table at the cached
blocks (copy-on-write paged KV) and prefills just its unique suffix — and
GoRouting's prefix-affinity term keeps each group pinned to the replica
already holding its KV.  The demo prints prefill tokens actually computed,
cache hit tokens, and client-edge TTFT for both runs.

    PYTHONPATH=src python -m repro_torch.examples.shared_prefix   # the card
    PYTHONPATH=src python -m repro_torch.examples.shared_prefix --smoke \\
        --device cpu
"""
import argparse
import asyncio

from ..sim import replay_frontend
from ..sim.replay import smoke_frontend, smoke_shared_prefix_trace


async def serve(n_requests: int, n_replicas: int, max_out: int,
                prefix_cache: bool, device) -> dict:
    frontend, cfg = smoke_frontend(n_replicas, prefix_cache=prefix_cache,
                                   w_p=4.0, device=device)
    await frontend.start()
    # 80% of streams share one of 2 system prompts; clipped to smoke size
    # (48-token prompts, 32-token shared span = 2 KV blocks).
    trace = smoke_shared_prefix_trace(n_requests, max_out=max_out)
    try:
        # speed 200x spreads arrivals over ~40ms so later requests of a
        # group actually find the first one's prefix in cache
        report = await replay_frontend(frontend, trace, cfg.vocab,
                                       speed=200.0, w_p=4.0)
    finally:
        await frontend.stop()
    engines = list(frontend.engines.values())
    out = {
        "completed": f"{report.n_completed}/{report.n_submitted}",
        "prefill_tokens": sum(e.stats.prefill_tokens for e in engines),
        "cache_hit_tokens": sum(e.stats.cache_hit_tokens for e in engines),
        "ttft_p50_s": round(report.summary.ttft_p50, 2),
        "wall_s": round(report.wall, 1),
    }
    for eng in engines:
        eng.kill()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: few requests, short outputs")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.requests or (8 if args.smoke else 48)
    max_out = 2 if args.smoke else 4
    results = {}
    for cache in (True, False):
        # the first pass pays the one-off kernel build and first launches;
        # report the warm pass so the on/off comparison is like for like
        asyncio.run(serve(n, args.replicas, max_out, cache, args.device))
        res = asyncio.run(serve(n, args.replicas, max_out, cache,
                                args.device))
        results[cache] = res
        print(f"prefix_cache={'on ' if cache else 'off'}  "
              + "  ".join(f"{k}={v}" for k, v in res.items()))
    return results


if __name__ == "__main__":
    main()
