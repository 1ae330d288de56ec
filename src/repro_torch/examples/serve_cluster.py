"""Async multi-replica serving demo (port of ``examples/serve_cluster.py``):
the industrial diurnal trace replayed through the streaming
``ServiceFrontend`` — 64+ concurrent requests of three priority classes,
GoRouting dispatch over torch engine replicas, continuous batching on
per-replica driver threads, and per-priority TTFT/TPOT SLO attainment +
gain measured at the CLIENT edge.  The tier is the launcher's
(``launch/serve.py`` ``serve_frontend``, the path of ``--mode frontend``).

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster   # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_cluster --smoke \\
        --device cpu
"""
import argparse

import torch

from ..configs import get_smoke
from ..launch import serve
from ..models.model import init_params, resolve_device


def run(n_requests: int, n_replicas: int, max_out: int, device) -> dict:
    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    # industrial mix (Fig. 1): 3 priority classes, diurnal phase shifts.
    # Clipped to smoke-model lengths; replayed at 1000x so the whole trace
    # is in flight concurrently.
    replay = serve.Replay(n_requests=n_requests, max_in=48, max_out=max_out)
    print(f"cluster: {n_replicas} engine replicas on {device}; replaying "
          f"{n_requests} requests ...")
    res = serve.serve_frontend(cfg, params, replay,
                               roles=("coloc",) * n_replicas,
                               pd_mode="coloc", device=device)
    report, frontend = res.report, res.frontend

    print(f"\n{report.n_completed}/{report.n_submitted} streams completed "
          f"({report.n_rejected} rejected) in {report.wall:.1f}s wall")
    s = report.summary
    print(f"client-edge overall: gain(TDG)={s.tdg_ratio:.3f} "
          f"SLO={s.slo_attainment:.2%} ttft_p50={s.ttft_p50:.2f}s "
          f"tpot_p50={s.tpot_p50:.3f}s")
    for p, m in sorted(report.per_priority.items()):
        print(f"  priority {p}: gain={m['tdg_ratio']:.3f} "
              f"SLO={m['slo']:.2%} ttft_p99={m['ttft_p99']:.2f}s")
    for iid, eng in res.engines.items():
        st = frontend.book.states.get(iid)
        speed = f", speed-EWMA {st.speed:.2f}" if st else ""
        print(f"  replica {iid}: {eng.stats.iterations} iters, "
              f"{eng.stats.tokens_out} tokens{speed}")
        eng.kill()
    return {"report": report, "frontend": frontend}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: few requests, short outputs")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.requests or (8 if args.smoke else 64)
    max_out = 2 if args.smoke else 4
    return run(n, args.replicas, max_out, resolve_device(args.device))


if __name__ == "__main__":
    main()
