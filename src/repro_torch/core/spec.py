"""Speculative-decoding depth policy and acceptance accounting (§gain).

ProServe frames scheduling as service-gain maximization; draft-model
FLOPs are discretionary spend.  This module holds the *pure* pieces the
scheduler, the live engine and the simulator all share, so the sim
mirror and the columnar fast path stay result-identical by
construction:

* ``useful_depth`` / ``load_depth`` / ``policy_depth`` — the depth
  controller.  Deterministic, numpy-vectorizable (scalars in, scalars
  out; arrays in, arrays out), and monotone non-increasing in load for
  fixed priority, so depth collapses toward 0 under load before
  SlideBatching sheds batch width.
* ``expected_tokens`` — expected emitted tokens per verify launch at a
  given depth and acceptance rate (1 + p + ... + p^d): the estimator
  prices expected accepted-tokens/s against verify cost with it.
* ``AcceptanceEWMA`` — the acceptance-rate feedback loop.
* ``SpecAccounting`` — proposed/accepted/rejected counters with the
  ``proposed == accepted + rejected`` invariant enforced at record time.
* ``sim_accept_draw`` — the simulator's deterministic pseudo-acceptance
  oracle (splitmix-style hash), shared by the reference EngineSim loop
  and VectorClusterSim so their streams are identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Marginal-gain floor: position d in the draft chain is only worth
# proposing while P(all d prior drafts accepted) = p^d stays above this.
MARGINAL_GAIN_MIN = 0.25
# Priorities <= this keep their full policy depth; each priority level
# below loses one position (draft FLOPs flow to high-priority requests).
PRIO_FULL_DEPTH = 1
# The simulator's ground-truth per-token draft acceptance probability.
# In the live engine this is a property of draft/target agreement; the
# sim models it as a workload constant that ``sim_accept_draw`` samples
# and ``AcceptanceEWMA`` *estimates*.  Drawing from the EWMA itself
# would close a degenerate feedback loop: E[accepted/depth] < rate for
# depth > 1, so the estimate spirals down until pricing zeroes depth.
SIM_TRUE_ACCEPT_RATE = 0.85


def useful_depth(rate, k_max: int):
    """Largest depth whose marginal expected gain clears the floor.

    ``rate`` may be a scalar or an ndarray; the result is clipped to
    [0, k_max].  rate >= 1 -> k_max, rate <= floor -> 0.
    """
    r = np.clip(rate, 0.0, 1.0)
    safe = np.maximum(r, 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.floor(np.log(MARGINAL_GAIN_MIN) / np.log(safe))
    d = np.where(r >= 1.0, k_max, np.where(r <= MARGINAL_GAIN_MIN, 0.0, d))
    return np.clip(d, 0, k_max).astype(np.int64)


def load_depth(load, k_max: int):
    """Depth budget from instantaneous load in [0, 1].

    ``k_max - floor(load * k_max)``: full depth while the batch budget
    is mostly free, stepping down to 0 as the budget fills.  Monotone
    non-increasing in ``load`` by construction.
    """
    lo = np.clip(load, 0.0, 1.0)
    return (k_max - np.floor(lo * k_max)).astype(np.int64)


def policy_depth(load, priority, rate, k_max: int):
    """The depth controller: min(rate-justified, load budget), then a
    per-priority-level penalty below ``PRIO_FULL_DEPTH``.  Always in
    [0, k_max]; monotone non-increasing in ``load`` for fixed priority
    and rate.  Scalar or columnar."""
    if k_max <= 0:
        z = np.zeros_like(np.asarray(load), dtype=np.int64)
        return z if np.ndim(load) else np.int64(0)
    d = np.minimum(useful_depth(rate, k_max), load_depth(load, k_max))
    penalty = np.maximum(np.asarray(priority) - PRIO_FULL_DEPTH, 0)
    d = np.maximum(d - penalty, 0)
    return d if np.ndim(d) else np.int64(d)


def expected_tokens(depth, rate):
    """Expected tokens emitted per verify at ``depth``: 1 + p + ... + p^d.

    Always >= 1 (the verify emits at least the greedy next token)."""
    r = np.clip(rate, 0.0, 1.0)
    d = np.asarray(depth, dtype=np.float64)
    geo = (1.0 - r ** (d + 1.0)) / np.maximum(1.0 - r, 1e-12)
    return np.where(r >= 1.0, d + 1.0, geo)


def price_depth(t0: float, overhead_of, d_cap: int, rate: float) -> int:
    """Pick the depth in [0, d_cap] maximizing expected tokens/s.

    ``t0`` is the plain decode cost, ``overhead_of(d)`` the extra verify
    + draft cost at depth d (0 at d=0).  Deterministic: first depth with
    a strictly greater rate wins ties, so depth 0 is the fixed point
    when speculation never pays."""
    best_d, best_v = 0, 1.0 / t0 if t0 > 0 else 0.0
    for d in range(1, int(d_cap) + 1):
        t = t0 + overhead_of(d)
        v = float(expected_tokens(d, rate)) / t if t > 0 else 0.0
        if v > best_v:
            best_d, best_v = d, v
    return best_d


class AcceptanceEWMA:
    """Exponentially-weighted acceptance rate, optimistic at start so
    speculation engages before the first measurement.

    ``probe()`` is the explore half of the loop.  The EWMA only
    observes outcomes while speculating, so a noisy dip below the
    estimator's pricing threshold would freeze the rate at
    zero-speculation forever (an absorbing state: no drafts, no
    observations, no recovery).  Every ``probe_every``-th
    declined-but-feasible opportunity forces a depth-1 draft to
    refresh the estimate."""

    def __init__(self, init: float = 0.8, alpha: float = 0.2,
                 probe_every: int = 16):
        self.rate = float(init)
        self.alpha = float(alpha)
        self.probe_every = int(probe_every)
        self._declined = 0

    def update(self, proposed: int, accepted: int) -> float:
        if proposed > 0:
            obs = accepted / proposed
            self.rate += self.alpha * (obs - self.rate)
        return self.rate

    def probe(self) -> bool:
        """Record one declined-but-feasible opportunity; True on every
        ``probe_every``-th, telling the scheduler to draft depth 1
        anyway.  Deterministic, so the sim's reference and vectorized
        paths stay result-identical."""
        self._declined += 1
        if self._declined >= self.probe_every:
            self._declined = 0
            return True
        return False


@dataclass
class SpecAccounting:
    """proposed == accepted + rejected, by construction, always."""
    proposed: int = 0
    accepted: int = 0
    rejected: int = 0
    depth_hist: dict = field(default_factory=dict)

    def record(self, depth: int, accepted: int) -> None:
        if not 0 <= accepted <= depth:
            raise ValueError(f"accepted {accepted} outside [0, {depth}]")
        self.proposed += depth
        self.accepted += accepted
        self.rejected += depth - accepted
        self.depth_hist[depth] = self.depth_hist.get(depth, 0) + 1

    def check(self) -> bool:
        return self.proposed == self.accepted + self.rejected


def _hash01(n: int) -> float:
    """Deterministic uniform draw in [0, 1) from an integer key."""
    x = (n * 2654435761) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 2246822519) & 0xFFFFFFFF
    x ^= x >> 13
    return x / 4294967296.0

def sim_accept_draw(rid: int, step: int, depth: int, rate: float) -> int:
    """Simulator acceptance oracle: leading-accept count of ``depth``
    independent hash draws against ``rate``.  Pure function of its
    arguments, so the reference loop and the vectorized sim agree."""
    a = 0
    for j in range(depth):
        if _hash01(rid * 1_000_003 + step * 7919 + j) < rate:
            a += 1
        else:
            break
    return a
