"""Gain functions from §2: Weighted SLO, TA-SLO and the paper's TDG (Eq. 1-3).

All gain functions share the signature ``gain(req, w_p, w_d) -> float`` so
benchmarks can swap them (Table 1 / Appendix E comparison).  ``w_p`` weights
the first token (responsiveness), ``w_d`` the decode tokens (fluency); both
are scaled by the request's priority weight ``req.weight``.
"""
from __future__ import annotations

import numpy as np

from .request import Request


def token_weight(req: Request, i: int, w_p: float, w_d: float) -> float:
    """w_r(i) of Eq. (3)."""
    return (w_p if i == 1 else w_d) * req.weight


def tdg_gain(req: Request, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """Token-level Deadline-aware Gain, Eq. (3).

    Each emitted token i earns w_r(i) iff it was delivered strictly before
    its FIXED deadline ``arrival + TTFT_SLO + (i-1)*TPOT_SLO``.  Fixed,
    independent deadlines give the two monotonicity properties of §2:
    early completion never hurts, late completion forfeits only that token
    (plus squeezing successors' slack) — no discard/postpone trick pays.
    """
    ts = req.out_times
    if len(ts) >= 32:
        # vectorized, bitwise identical to the loop: same per-token deadline
        # expression shape, late tokens enter the sequential accumulation
        # as +0.0 (exact for the non-negative weights)
        m = len(ts)
        dl = req.arrival + req.slo.ttft + np.arange(m) * req.slo.tpot
        terms = np.where(np.asarray(ts) < dl, w_d * req.weight, 0.0)
        if ts[0] < dl[0]:
            terms[0] = w_p * req.weight
        return float(np.add.accumulate(terms)[-1])
    g = 0.0
    for i, t in enumerate(req.out_times, start=1):
        if t < req.slo.token_deadline(req.arrival, i):
            g += token_weight(req, i, w_p, w_d)
    return g


def ideal_gain(req: Request, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """Upper bound: every token of the request delivered on time."""
    if req.output_len <= 0:
        return 0.0
    return (w_p + (req.output_len - 1) * w_d) * req.weight


def tdg_ratio(reqs, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """System gain metric TDG_Ratio = sum f_TDG / Ideal_Gain (§5.1)."""
    got = sum(tdg_gain(r, w_p, w_d) for r in reqs)
    ideal = sum(ideal_gain(r, w_p, w_d) for r in reqs)
    return got / ideal if ideal > 0 else 0.0


# --- strawman baselines (kept for the Table-1/Appendix-E comparison) -----

def weighted_slo_gain(req: Request, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """Strawman 1, Eq. (1): all-or-nothing request-level attainment.

    Vulnerable to the discard-or-postpone trick: once TTFT is missed the
    request is worthless to the metric.
    """
    del w_p, w_d
    return req.weight if req.met_slo() else 0.0


def ta_slo_gain(req: Request, w_p: float = 1.0, w_d: float = 1.0) -> float:
    """Refined proposal 2, Eq. (2): TBT-based token accumulation.

    Vulnerable to the postponed-decoding trick: delaying an already-late
    token can rescue the NEXT token's TBT (negative monotonicity of TBT).
    """
    g = 0.0
    if req.out_times:
        if req.out_times[0] - req.arrival < req.slo.ttft:
            g += w_p * req.weight
        tbt_slo = req.slo.tpot
        for prev, cur in zip(req.out_times, req.out_times[1:]):
            if cur - prev < tbt_slo:
                g += w_d * req.weight
    return g


GAIN_FUNCTIONS = {
    "tdg": tdg_gain,
    "weighted_slo": weighted_slo_gain,
    "ta_slo": ta_slo_gain,
}
