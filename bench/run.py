"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 bench/run.py --workload qwen2_7b.chat --seed 1 --seconds 51 \
        --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice of the window.  Every run checks
the served tokens against the plain reference and prints the numbers
compared, with their limits, as the last lines of standard error and
under ``check`` in the result.  Needs a CUDA card; exits 1 without one,
printing no result.
"""
from __future__ import annotations

import time

T_START = time.monotonic()          # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; the benchmark "
              "measures the card only", file=sys.stderr)
        return 1
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    chips = int(cell.entry["chips"])
    if torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1

    def log(*a, **kw):
        kw.setdefault("file", sys.stderr)
        print(*a, **kw, flush=True)

    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, device="cuda",
                           root=ROOT, log=log)
    if res["forbidden"]:
        print(f"bench: the process loaded {res['forbidden']}",
              file=sys.stderr)
        return 1
    run, chk = res["run"], res["check"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(res["peak"])}
    out = {"correct": chk["correct"], "attempted": len(run.measured),
           "failed": sum(r.failed for r in run.measured),
           "metrics": res["metrics"], "device": dev}
    if args.trace:
        prof = run.prof
        if prof is None:
            print("bench: the profiled slice recorded nothing",
                  file=sys.stderr)
            return 1
        dev.update(busy_s=prof.busy_s, window_s=prof.wall_s)
        ops = sorted(prof.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(prof.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k[:120], v[0]] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in gaps]}
    # what the run saw besides its metrics, for the record
    print(json.dumps({"info": harness.info(run, res)}), flush=True)
    out["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                    for k, v in chk["numbers"].items()}
    for k, v in chk["numbers"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r}"
            f"{', holds' if v['holds'] else ', FAILS'})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
