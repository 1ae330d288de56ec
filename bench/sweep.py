"""The knee sweep of one cell's configuration and mix: the same run at
several fixed rates in one process (set-up paid per rate, the kernels
built once), each rate's attainment and backlog printed as one JSON line.
Used once, when a cell is defined, to fix the rate in its traffic file;
the benchmark's own runs never call it.

    python3 bench/sweep.py --workload qwen2_7b.chat --rates 2,4,6 \
        --seconds 30 [--seed 7]

Each row gives the share of the requests due in the window that met
both of their class's limits, per class too, and the queue each second:
the knee is read from them (PERF.md says how).
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench import harness
    for rate in [float(r) for r in args.rates.split(",")]:
        t0 = time.monotonic()
        res = harness.run_cell(args.workload, args.seed, args.seconds, False,
                               t_start=t0, device=args.device, rate=rate,
                               do_check=False, root=ROOT,
                               log=lambda *a, **k: print(*a, file=sys.stderr))
        del res["weights"]
        row = harness.info(res["run"], res)
        row["wall_s"] = time.monotonic() - t0
        print(json.dumps({"sweep": row}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
