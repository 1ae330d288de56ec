"""End-to-end serving example (port of ``examples/priority_serving.py``): a
reduced Qwen1.5 config served with batched multi-priority requests through
the whole stack of the port — SlideBatching, the paged KV pool, packed and
chunked prefill, paged decode (the hand-written kernels on the card, their
plain versions on the CPU), priority preemption with host offload and
reload — and every stream checked against uninterrupted greedy decoding.

    PYTHONPATH=src python -m repro_torch.examples.priority_serving   # the card
    PYTHONPATH=src python -m repro_torch.examples.priority_serving --smoke \\
        --device cpu
"""
import argparse
import time

import numpy as np
import torch

from ..configs import get_smoke
from ..core import SLO, EngineConfig, Request, make_policy
from ..core.tdg import tdg_ratio
from ..models.model import greedy_generate, init_params, resolve_device
from ..serving import Engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: shorter outputs")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out_len = 4 if args.smoke else 8

    dev = resolve_device(args.device)
    cfg = get_smoke("qwen1_5_0_5b")      # reduced qwen1.5 family config
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)

    # deliberately tiny pool so high-priority arrivals preempt low-priority
    eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                 make_policy("slidebatching"), num_blocks=20, block_size=16,
                 max_ctx=256, device=dev)

    reqs = []
    for i in range(args.requests):
        prio = 1 if i % 3 == 0 else 2
        plen = int(rng.integers(16, 48))
        r = Request(prompt_len=plen, output_len=out_len, arrival=0.0,
                    slo=SLO(ttft=30.0, tpot=10.0), priority=prio,
                    weight=2.0 if prio == 1 else 1.0)
        prompt = rng.integers(1, cfg.vocab, plen).astype(np.int32)
        eng.add_request(r, prompt)
        reqs.append((r, prompt))

    t0 = time.time()
    eng.run_until_drained()
    wall = time.time() - t0
    eng.kill()

    ratio = tdg_ratio([r for r, _ in reqs], w_p=4.0)
    print(f"served {len(reqs)} multi-priority requests in {wall:.1f}s "
          f"({eng.stats.iterations} iterations, "
          f"{eng.stats.tokens_out} tokens, "
          f"{eng.stats.evictions} preemption evictions, "
          f"{eng.stats.reload_blocks} blocks reloaded)")
    print(f"TDG_Ratio = {ratio:.3f}")

    # every stream against uninterrupted greedy generation
    print("\nverifying against teacher-forced greedy reference...")
    exact = {}
    for r, prompt in reqs:
        exact[r.rid] = eng.outputs[r.rid] == greedy_generate(
            cfg, params, prompt, r.output_len)
        print(f"  rid={r.rid} prio={r.priority} "
              f"preemptions={r.preemptions} exact={exact[r.rid]}")
    if not all(exact.values()):
        raise SystemExit("preemption path corrupted generation")
    print("\nall outputs token-for-token exact through preemption")
    return {"engine": eng, "requests": reqs, "cfg": cfg, "params": params,
            "exact": exact, "tdg_ratio": ratio}


if __name__ == "__main__":
    main()
