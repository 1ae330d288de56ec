"""The arithmetic that turns client-edge stamps into end-to-end metrics.

``tdg_gain``, ``ideal_gain`` and ``tdg_ratio`` are copied from
``repro_torch.core.tdg`` (TDG_Ratio of the paper, §5.1, Eq. 3), frozen
here so that no change to the program moves the yardstick.  They read any
object with ``arrival``, ``ttft_s``, ``tpot_s``, ``weight``,
``output_len`` and ``out_times`` (absolute seconds on one clock).
"""
from __future__ import annotations

import math

import numpy as np


def tdg_gain(r, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """Each emitted token i earns ``w(i) * weight`` iff it arrived strictly
    before ``arrival + ttft + (i - 1) * tpot``; ``w(1) = w_p``, else
    ``w_d``."""
    g = 0.0
    for i, t in enumerate(r.out_times, start=1):
        if t < r.arrival + r.ttft_s + (i - 1) * r.tpot_s:
            g += (w_p if i == 1 else w_d) * r.weight
    return g


def ideal_gain(r, w_p: float = 1.0, w_d: float = 1.0) -> float:
    if r.output_len <= 0:
        return 0.0
    return (w_p + (r.output_len - 1) * w_d) * r.weight


def tdg_ratio(reqs, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """Sum of gains over the ideal; a failed request (``failed`` true)
    adds its ideal to the denominator and nothing to the numerator."""
    got = sum(tdg_gain(r, w_p, w_d) for r in reqs if not r.failed)
    ideal = sum(ideal_gain(r, w_p, w_d) for r in reqs)
    return got / ideal if ideal > 0 else 0.0


def percentile(values, q: float) -> float:
    """numpy's linear percentile; ``inf`` entries (failed requests) rank
    above every finite one."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    pos = (len(v) - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if not math.isfinite(v[hi]):
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def finite_or(value: float, cap: float) -> float:
    """A percentile that landed on failed requests reads as ``cap``, the
    longest a request could have been waited for in the run."""
    return value if math.isfinite(value) else cap
