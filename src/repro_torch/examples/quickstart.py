"""Quickstart: ProServe's scheduling core on the cluster simulator (port
of ``examples/quickstart.py``).

Runs a multi-priority ShareGPT-like workload through SlideBatching and the
baselines on a simulated 4-chip TPU-v5e instance and prints the paper's
headline metrics (TDG_Ratio + SLO attainment, overall and per priority).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --smoke

The simulator runs on the host: this example needs no card.
"""
import argparse

from ..core import EngineConfig, make_policy
from ..sim import (AnalyticalExecutor, EngineSim, InstanceHardware,
                   QWEN2_7B, summarize)
from ..sim.workloads import sharegpt


def drive(engine, reqs):
    pending = sorted(reqs, key=lambda r: r.arrival)
    now, i = 0.0, 0
    while i < len(pending) or engine.has_work():
        while i < len(pending) and pending[i].arrival <= now:
            engine.add_request(pending[i], now)
            i += 1
        res = engine.step(now)
        if res is None:
            if i >= len(pending):
                break
            now = pending[i].arrival
        else:
            now = res.end


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: a shorter trace, two schedulers")
    args = ap.parse_args(argv)
    executor = AnalyticalExecutor(QWEN2_7B, InstanceHardware(chips=4))
    estimator, mape = executor.fit_estimator(n=100 if args.smoke else 400)
    print(f"batch-latency estimator fitted: MAPE={mape:.1%} "
          f"(paper reports ~4.5%)\n")

    print(f"{'scheduler':18s} {'TDG':>6s} {'SLO':>6s} "
          f"{'TDG hi':>7s} {'TDG lo':>7s} {'ttft p99':>9s}")
    names = (("slidebatching", "sarathi_fcfs") if args.smoke else
             ("slidebatching", "sarathi_fcfs", "vllm_fcfs",
              "sarathi_priority", "weighted_vtc", "fair_batching"))
    rows = {}
    for name in names:
        reqs = sharegpt(rate=85, duration=4 if args.smoke else 20, seed=0)
        eng = EngineSim(0, make_policy(name), executor, estimator,
                        EngineConfig(w_p=4.0))
        drive(eng, reqs)
        s = summarize(reqs, w_p=4.0)
        rows[name] = s
        print(f"{name:18s} {s.tdg_ratio:6.3f} {s.slo_attainment:6.3f} "
              f"{s.per_priority[1]['tdg_ratio']:7.3f} "
              f"{s.per_priority[2]['tdg_ratio']:7.3f} "
              f"{s.ttft_p99:9.3f}")
    return rows


if __name__ == "__main__":
    main()
