"""Readings that set a configuration's check limits (not run by
the benchmark's own runs).  For each seed, one run of the cell as the
benchmark runs it (``--seconds`` may be shorter), then ``check.check``
on its sample of finished requests twice: once as every run judges the
program, and, for the control seeds, once with the control standing in
for the program (``check.control_gaps``: the reference with TF32
matmuls, scored by the fp32 reference).  The control has to come out
not correct.  One JSON line per seed.

    python3 bench/control.py --workload qwen2_7b.chat --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 20
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench import check, harness

    def log(*a, **k):
        k["file"] = sys.stderr
        print(*a, **k)

    def judged(res):
        return {"correct": res["correct"],
                "numbers": {k: [v["value"], v["limit"]]
                            for k, v in res["numbers"].items()},
                "not_first_choice": res["readings"]["not_first_choice"]}

    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               t_start=t0, device=args.device,
                               do_check=False, root=ROOT, log=log)
        run = res["run"]
        weights = res.pop("weights")
        row = {"seed": seed, "measured": len(run.measured),
               "failed": sum(r.failed for r in run.measured),
               "program": judged(check.check(run.cell, run, weights, seed,
                                             log=log))}
        if seed in ctrl:
            row["control"] = judged(check.check(
                run.cell, run, weights, seed, log=log,
                gaps=check.control_gaps))
        row["wall_s"] = time.monotonic() - t0
        print(json.dumps({"control": row}), flush=True)
        del weights, res, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
