"""Reductions the metric readers share: client-edge times of the
measured requests, spans inside the window, the profiled slice's model
calls and kernels.  Each returns None where the run has nothing to
read."""
from __future__ import annotations

import math

from . import cost, yardstick

W_P = 4.0      # TDG_Ratio's first-token weight (the port's serve.W_P)


def cap_s(run) -> float:
    """The longest a measured request could be waited for in the run."""
    mix = run.cell.mix
    return run.seconds + float(mix["drain_limit_s"]) + float(mix["ramp_s"])


def ttfts(run) -> list:
    return [r.out_times[0] - r.arrival if not r.failed and r.out_times
            else math.inf for r in run.measured]


def tpots(run) -> list:
    out = []
    for r in run.measured:
        t = r.out_times
        out.append((t[-1] - t[0]) / (len(t) - 1)
                   if not r.failed and len(t) >= 2 else math.inf)
    return out


def pct(values: list, q: float, cap: float):
    if not values:
        return None
    return yardstick.finite_or(yardstick.percentile(values, q), cap)


def p95(values: list, cap: float):
    return pct(values, 95.0, cap)


def tdg(run):
    return yardstick.tdg_ratio(run.measured, w_p=W_P) if run.measured \
        else None


def window_tokens_per_s(run):
    a, b = run.window
    n = sum(1 for r in run.recs for t in r.out_times if a <= t < b)
    return n / run.seconds


def late_ms(run) -> list:
    """How late each measured request was submitted, ms; in a traced run
    without the requests due while the profiler started or stopped."""
    stalls = run.inst.stalls
    return [1e3 * (r.submitted - r.arrival) for r in run.measured
            if math.isfinite(r.submitted)
            and not any(a <= r.arrival <= b for a, b in stalls)]


def _inside(run, attr: str) -> list:
    """Durations of the spans that began and ended inside the window."""
    a, b = run.window
    return [t1 - t0 for t0, t1 in getattr(run.inst, attr)
            if a <= t0 and t1 <= b]


def spans_ms(run, attr: str):
    d = _inside(run, attr)
    return 1e3 * sum(d) if d else None


def span_count(run, attr: str) -> int:
    return len(_inside(run, attr))


def pool_peak(run):
    """Most blocks of the paged pool in use after any step of the
    window."""
    a, b = run.window
    used = [n for t, n in run.inst.pool_used if a <= t <= b]
    return max(used) if used else None


def slice_calls(run, kind: str) -> list:
    """Rows of the engine's model calls that started in the slice."""
    if run.prof is None:
        return []
    a, b = run.inst.slice
    return [m[3] for m in run.inst.model if m[2] == kind and a <= m[0] < b]


def device_share(run, seconds: float):
    return 100.0 * seconds / run.prof.wall_s


def mfu(run):
    if run.prof is None or run.peaks is None:
        return None
    flops = sum(cost.rows_flops(run.arch, rows)
                for kind in ("prefill", "decode")
                for rows in slice_calls(run, kind))
    if not flops:
        return None
    return 100.0 * flops / (run.prof.wall_s
                            * run.peaks["fp32_flops_per_s"])


def kernel_time(run, needle: str) -> tuple:
    rows = [v for k, v in run.prof.by_name.items() if needle in k]
    return sum(v[0] for v in rows), sum(v[1] for v in rows)


def kernel_roofline(run, kind: str, needle: str, work):
    """Mean bound per launch over mean device time per launch, in %;
    ``work(arch, rows)`` gives one launch's (FLOPs, bytes)."""
    if run.prof is None or run.peaks is None:
        return None
    calls = slice_calls(run, kind)
    secs, n = kernel_time(run, needle)
    if not calls or not n or secs <= 0:
        return None
    bound = sum(cost.bound_s(*work(run.arch, rows), run.peaks)
                for rows in calls) / len(calls)
    return 100.0 * bound / (secs / n)


def decode_roofline(run):
    return kernel_roofline(
        run, "decode", "paged_decode_kernel",
        lambda arch, rows: cost.decode_attention(arch, [c for c, _, _ in
                                                        rows]))


def prefill_roofline(run):
    return kernel_roofline(run, "prefill", "packed_prefill_kernel",
                           cost.prefill_attention)


def copy_share(run):
    if run.prof is None:
        return None
    secs = sum(v[0] for k, v in run.prof.by_name.items()
               if k.startswith(("Memcpy DtoH", "Memcpy HtoD")))
    return device_share(run, secs)


def idle_share(run):
    if run.prof is None:
        return None
    return 100.0 - device_share(run, run.prof.busy_s)


def hit_share(run):
    reqs = [r for r in run.measured if r.req.rid in run.inst.hits]
    total = sum(len(r.planned.prompt) for r in reqs)
    return 100.0 * sum(r.hit_tokens for r in reqs) / total if total else None


def p50(values: list):
    finite = [v for v in values if math.isfinite(v)]
    return yardstick.percentile(finite, 50.0) if finite else None


def slo_met(run):
    """Share of the requests due in the window that met both limits."""
    meas = run.measured
    if not meas:
        return None
    ok = sum(1 for r, f, p in zip(meas, ttfts(run), tpots(run))
             if f < r.ttft_s and p < r.tpot_s)
    return ok / len(meas)


def by_class(run) -> dict:
    """Per priority: requests due in the window, the share that met both
    limits, TTFT and TPOT medians."""
    out = {}
    rows = list(zip(run.measured, ttfts(run), tpots(run)))
    for p in sorted({r.planned.priority for r in run.measured}):
        mine = [(r, f, t) for r, f, t in rows if r.planned.priority == p]
        out[p] = {"n": len(mine),
                  "met": sum(f < r.ttft_s and t < r.tpot_s
                             for r, f, t in mine) / len(mine),
                  "ttft_p50_s": p50([f for _, f, _ in mine]),
                  "tpot_p50_s": p50([t for _, _, t in mine])}
    return out
