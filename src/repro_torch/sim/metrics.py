"""Evaluation metrics (§5.1): TDG_Ratio, SLO attainment, latency
distributions, per-priority splits, and the urgent/timeout timelines of
Figs. 7 & 22."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from ..core.request import Request
from ..core.tdg import ideal_gain, tdg_gain, tdg_ratio


@dataclass
class Summary:
    n: int
    tdg_ratio: float
    slo_attainment: float
    ttft_p50: float
    ttft_p99: float
    tpot_p50: float
    tpot_p99: float
    per_priority: dict[int, dict[str, float]] = field(default_factory=dict)

    def row(self) -> dict:
        d = {"n": self.n, "tdg_ratio": round(self.tdg_ratio, 4),
             "slo": round(self.slo_attainment, 4),
             "ttft_p50": round(self.ttft_p50, 4),
             "ttft_p99": round(self.ttft_p99, 4),
             "tpot_p50": round(self.tpot_p50, 4),
             "tpot_p99": round(self.tpot_p99, 4)}
        for p, m in sorted(self.per_priority.items()):
            d[f"tdg_p{p}"] = round(m["tdg_ratio"], 4)
            d[f"slo_p{p}"] = round(m["slo"], 4)
        return d


def _pct(vals: list[float], q: float) -> float:
    return float(np.percentile(vals, q)) if vals else float("nan")


def summarize(reqs: Iterable[Request], w_p: float = 1.0,
              w_d: float = 1.0) -> Summary:
    reqs = list(reqs)
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    tpots = [r.tpot for r in reqs if r.tpot is not None]
    slo = (np.mean([r.met_slo() for r in reqs]) if reqs else 0.0)
    per_prio: dict[int, dict[str, float]] = {}
    for p in sorted({r.priority for r in reqs}):
        sub = [r for r in reqs if r.priority == p]
        per_prio[p] = {
            "tdg_ratio": tdg_ratio(sub, w_p, w_d),
            "slo": float(np.mean([r.met_slo() for r in sub])),
            "ttft_p99": _pct([r.ttft for r in sub if r.ttft is not None], 99),
        }
    return Summary(
        n=len(reqs),
        tdg_ratio=tdg_ratio(reqs, w_p, w_d),
        slo_attainment=float(slo),
        ttft_p50=_pct(ttfts, 50), ttft_p99=_pct(ttfts, 99),
        tpot_p50=_pct(tpots, 50), tpot_p99=_pct(tpots, 99),
        per_priority=per_prio)


class _Buf:
    """Growable float64 value buffer: O(1) amortized append, memory-compact
    (vs a Python float list: 8 bytes/value instead of ~60)."""

    __slots__ = ("_a", "_n")

    def __init__(self, cap: int = 1024):
        self._a = np.empty(cap)
        self._n = 0

    def append(self, x: float) -> None:
        if self._n == len(self._a):
            b = np.empty(2 * len(self._a))
            b[:self._n] = self._a
            self._a = b
        self._a[self._n] = x
        self._n += 1

    def values(self) -> np.ndarray:
        return self._a[:self._n]

    def __len__(self) -> int:
        return self._n

    def merge(self, other: "_Buf") -> None:
        k = other._n
        while self._n + k > len(self._a):
            b = np.empty(2 * len(self._a))
            b[:self._n] = self._a[:self._n]
            self._a = b
        self._a[self._n:self._n + k] = other._a[:k]
        self._n += k

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values(), q))


class _LogHist:
    """Bounded-memory latency sketch: log-spaced bins over [LO, HI) with
    ratio ``RATIO`` per bin, plus under/overflow bins.

    Chosen over reservoir sampling / P² because shard-merge must be
    EXACT (tests/test_shard_merge.py): int64 bin counts add exactly
    under any partition of the input, so merged percentiles equal the
    unsharded run's bit for bit.  A percentile is reported as the
    geometric midpoint of the bin holding that order statistic —
    relative error <= sqrt(RATIO) - 1 (~0.25%), inside the 1% bar the
    10⁵ reference-run assertion enforces.  Memory: NBINS int64 ≈ 44 KB
    per sketch, independent of request count.
    """

    LO, HI, RATIO = 1e-7, 1e5, 1.005
    _LOG_RATIO = math.log(RATIO)
    NBINS = int(math.ceil(math.log(HI / LO) / _LOG_RATIO)) + 2

    __slots__ = ("counts", "_n")

    def __init__(self):
        self.counts = np.zeros(self.NBINS, np.int64)
        self._n = 0

    def append(self, x: float) -> None:
        if x < self.LO:
            i = 0
        elif x >= self.HI:
            i = self.NBINS - 1
        else:
            i = 1 + int(math.log(x / self.LO) / self._LOG_RATIO)
        self.counts[i] += 1
        self._n += 1

    def __len__(self) -> int:
        return self._n

    def merge(self, other: "_LogHist") -> None:
        self.counts += other.counts
        self._n += other._n

    def _bin_value(self, i: int) -> float:
        if i <= 0:
            return self.LO
        if i >= self.NBINS - 1:
            return self.HI
        return self.LO * self.RATIO ** (i - 1) * math.sqrt(self.RATIO)

    def percentile(self, q: float) -> float:
        """numpy 'linear' interpolation between the two order statistics
        bracketing rank q/100*(n-1), each located via the bin cumsum."""
        if self._n == 0:
            return float("nan")
        r = q / 100.0 * (self._n - 1)
        k = int(math.floor(r))
        frac = r - k
        cum = np.cumsum(self.counts)
        lo = self._bin_value(int(np.searchsorted(cum, k + 1)))
        if frac <= 0.0:
            return lo
        hi = self._bin_value(int(np.searchsorted(cum, k + 2)))
        return lo + frac * (hi - lo)


class StreamingSummary:
    """Constant-overhead ``summarize``: fold requests one at a time as they
    finish (``ClusterSim.run_stream`` callback) so a 10⁶-request replay
    never holds per-request Python lists for metrics.

    Exactness vs ``summarize`` on the same request set: percentiles and
    SLO attainment are exact (same value multiset / integer counts
    regardless of fold order); the TDG gain sums accumulate in completion
    order instead of trace order, which is also exact whenever per-token
    gains are integer-valued in float64 (all bundled workloads use integer
    weights) and otherwise agrees to float rounding.

    ``bounded=True`` swaps the growable per-request latency buffers for
    ``_LogHist`` sketches: memory becomes independent of request count
    (10⁶-scale replays) at <= ~0.25% relative percentile error.

    ``merge`` folds another summary in (same ``w_p``/``w_d``/``bounded``),
    the reduction the sharded replay uses: counters and histogram bins
    add exactly, so merging per-shard summaries from ANY partition of a
    trace reproduces the unsharded metrics (property-tested in
    tests/test_shard_merge.py).
    """

    def __init__(self, w_p: float = 1.0, w_d: float = 1.0,
                 bounded: bool = False):
        self.w_p, self.w_d = w_p, w_d
        self.bounded = bounded
        self._mk = _LogHist if bounded else _Buf
        self.n = 0
        self._met = 0
        self._got = 0.0
        self._ideal = 0.0
        self._ttft = self._mk()
        self._tpot = self._mk()
        # priority -> [got, ideal, met, n, ttft_buf]
        self._prio: dict[int, list] = {}

    def add(self, r: Request) -> None:
        self.n += 1
        got = tdg_gain(r, self.w_p, self.w_d)
        ideal = ideal_gain(r, self.w_p, self.w_d)
        met = r.met_slo()
        self._got += got
        self._ideal += ideal
        self._met += met
        ttft, tpot = r.ttft, r.tpot
        if ttft is not None:
            self._ttft.append(ttft)
        if tpot is not None:
            self._tpot.append(tpot)
        acc = self._prio.get(r.priority)
        if acc is None:
            acc = self._prio[r.priority] = [0.0, 0.0, 0, 0, self._mk()]
        acc[0] += got
        acc[1] += ideal
        acc[2] += met
        acc[3] += 1
        if ttft is not None:
            acc[4].append(ttft)

    def merge(self, other: "StreamingSummary") -> None:
        if (self.w_p, self.w_d, self.bounded) != \
                (other.w_p, other.w_d, other.bounded):
            raise ValueError("merging incompatible StreamingSummary shards")
        self.n += other.n
        self._met += other._met
        self._got += other._got
        self._ideal += other._ideal
        self._ttft.merge(other._ttft)
        self._tpot.merge(other._tpot)
        for p, o in other._prio.items():
            acc = self._prio.get(p)
            if acc is None:
                acc = self._prio[p] = [0.0, 0.0, 0, 0, self._mk()]
            acc[0] += o[0]
            acc[1] += o[1]
            acc[2] += o[2]
            acc[3] += o[3]
            acc[4].merge(o[4])

    def summary(self) -> Summary:
        per_prio = {}
        for p in sorted(self._prio):
            got, ideal, met, n, ttfts = self._prio[p]
            per_prio[p] = {
                "tdg_ratio": got / ideal if ideal > 0 else 0.0,
                "slo": met / n if n else 0.0,
                "ttft_p99": (ttfts.percentile(99)
                             if len(ttfts) else float("nan")),
            }
        return Summary(
            n=self.n,
            tdg_ratio=self._got / self._ideal if self._ideal > 0 else 0.0,
            slo_attainment=self._met / self.n if self.n else 0.0,
            ttft_p50=(self._ttft.percentile(50)
                      if len(self._ttft) else float("nan")),
            ttft_p99=(self._ttft.percentile(99)
                      if len(self._ttft) else float("nan")),
            tpot_p50=(self._tpot.percentile(50)
                      if len(self._tpot) else float("nan")),
            tpot_p99=(self._tpot.percentile(99)
                      if len(self._tpot) else float("nan")),
            per_priority=per_prio)


# disagg two-leg accounting: ClusterSim and the live RouterBook expose
# these counters under identical attribute names, so the sim<->live
# parity gate (tools/perf_smoke.py) is a dict equality.
DISAGG_COUNTERS = ("handoffs", "handoff_blocks", "handoff_bytes",
                   "reservation_hits", "reservation_misses",
                   "reserved_blocks_total", "adopted_blocks_total")


def disagg_counters(source) -> dict[str, int]:
    """Disagg handoff/reservation counters from a ``ClusterSim`` or a
    live ``serving.dispatch.RouterBook``."""
    return {k: int(getattr(source, k)) for k in DISAGG_COUNTERS}


# speculative-decoding accounting: EngineSim / ClusterSim and the live
# EngineStats expose these under identical attribute names, so the
# sim<->live parity gate (tools/perf_smoke.py) is again a dict equality.
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rejected")


def spec_counters(source) -> dict:
    """Speculation counters (plus the depth histogram) from an
    ``EngineSim``, ``ClusterSim`` or live ``serving.engine.EngineStats``."""
    out: dict = {k: int(getattr(source, k)) for k in SPEC_COUNTERS}
    out["spec_depth_hist"] = {int(d): int(n) for d, n in
                              sorted(dict(source.spec_depth_hist).items())}
    return out


def gain_timeline(reqs: Iterable[Request], bucket: float = 1.0,
                  w_p: float = 1.0, w_d: float = 1.0) -> dict[int, float]:
    """TDG earned per time bucket (Fig. 21)."""
    out: dict[int, float] = {}
    for r in reqs:
        for i, t in enumerate(r.out_times, start=1):
            if t < r.slo.token_deadline(r.arrival, i):
                w = (w_p if i == 1 else w_d) * r.weight
                out[int(t // bucket)] = out.get(int(t // bucket), 0.0) + w
    return out


def urgent_timeout_timeline(reqs: Iterable[Request], horizon: float,
                            bucket: float = 1.0,
                            urgent_window: float = 1.0) -> dict:
    """Counts of urgent (approaching first-token deadline) and timed-out
    requests over time (Figs. 7/22)."""
    nb = int(horizon // bucket) + 1
    urgent = np.zeros(nb)
    timeout = np.zeros(nb)
    for r in reqs:
        dl = r.slo.token_deadline(r.arrival, 1)
        first = r.out_times[0] if r.out_times else float("inf")
        # urgent while waiting within `urgent_window` of the deadline
        t0, t1 = dl - urgent_window, min(first, dl)
        for b in range(max(0, int(t0 // bucket)),
                       min(nb - 1, int(t1 // bucket)) + 1):
            if t0 <= (b + 0.5) * bucket <= t1:
                urgent[b] += 1
        if first > dl:
            b = int(min(dl, horizon - 1e-9) // bucket)
            timeout[b] += 1
    return {"urgent": urgent.tolist(), "timeout": timeout.tolist(),
            "bucket": bucket}
