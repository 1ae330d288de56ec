"""Batch latency estimator (§4.1, Eq. 4-7).

Per-request core latencies:
    prefill:  T~_p(r) = a_p * l_q^2 + b_p * l_q * l_kv + c_p * l_q      (5)
    decode:   T~_d(r) = a_d * l_kv + b_d                                 (6)
Batch latency:
    T(B) = sum_r T~(r) + t_c                                            (7)

The quadratic l_q^2 term captures intra-chunk attention, l_q*l_kv the
attention against cached context (chunked prefill / prefix caching
compatible), c_p*l_q the linear (MLP/projection) cost.  Decode is
memory-bound: a_d*l_kv is the KV read, b_d the per-sequence overhead.

Coefficients {a_p,b_p,c_p,a_d,b_d,t_c} are fit by least squares on profiled
batches (offline, §4.1).  Because the batch time is LINEAR in the summed
per-request features, we fit one joint regression on batch-level aggregated
features — exactly the estimator a production deployment trains from engine
step logs.  The paper reports MAPE ~= 4.5%; we report ours in
EXPERIMENTS.md (benchmarks/bench_estimator.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

# A forward-pass work item: (l_q, l_kv, is_prefill).
#   l_q  : tokens processed this pass (chunk size for prefill, 1 for decode)
#   l_kv : KV context length already cached BEFORE this pass
WorkItem = tuple[int, int, bool]

# Wire-byte ratio of a cold (int8 + per-plane fp32 scales) KV block to a
# hot (fp32) one: the H2D copy of a cold-tier reload moves ~4x fewer
# bytes (see kernels/kv_quant.py); its on-device dequant is fused into
# the staging scatter and is bandwidth-trivial next to the PCIe copy.
COLD_WIRE_RATIO = 0.25

# Speculative decoding cost model (core/spec.py drives depth with it).
# An extra verify row rides the same packed launch as the base decode
# row, so it costs a fraction of a standalone decode pass; each draft
# proposal costs a small-model decode step priced relative to the
# target's.  Both are ratios of T~_d(l_kv) so the fitted coefficients
# keep working without a separate speculation profile.
VERIFY_ROW_RATIO = 0.35
DRAFT_COST_RATIO = 0.2


def _features(items: Iterable[WorkItem]) -> np.ndarray:
    """Aggregate batch features [sum l_q^2, sum l_q*l_kv, sum l_q, sum l_kv_d, n_d, 1]."""
    items = list(items)
    if len(items) >= 32:
        return _features_cols(*_as_cols(items))
    f = np.zeros(6, dtype=np.float64)
    for l_q, l_kv, is_prefill in items:
        if is_prefill:
            f[0] += float(l_q) * l_q
            f[1] += float(l_q) * l_kv
            f[2] += float(l_q)
        else:
            f[3] += float(l_kv) + l_q  # decode reads ctx incl. current token
            f[4] += 1.0
    f[5] = 1.0
    return f


def _as_cols(items: Sequence[WorkItem]):
    arr = np.asarray(items, dtype=np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2] != 0.0


def _features_cols(l_q: np.ndarray, l_kv: np.ndarray,
                   is_prefill: np.ndarray) -> np.ndarray:
    """Columnar `_features`, bitwise identical to the scalar loop: masked
    rows contribute +0.0 (exact for these non-negative terms) and each
    column is reduced with the sequential ``np.add.accumulate`` — the
    pairwise ``np.sum`` would NOT reproduce the loop's rounding."""
    f = np.zeros(6, dtype=np.float64)
    if l_q.size:
        pf = is_prefill.astype(np.float64)
        df = 1.0 - pf
        f[0] = np.add.accumulate(pf * (l_q * l_q))[-1]
        f[1] = np.add.accumulate(pf * (l_q * l_kv))[-1]
        f[2] = np.add.accumulate(pf * l_q)[-1]
        f[3] = np.add.accumulate(df * (l_kv + l_q))[-1]
        f[4] = np.add.accumulate(df)[-1]
    f[5] = 1.0
    return f


@dataclass
class BatchLatencyEstimator:
    a_p: float = 0.0
    b_p: float = 0.0
    c_p: float = 0.0
    a_d: float = 0.0
    b_d: float = 0.0
    t_c: float = 0.0

    # --- prediction -------------------------------------------------------
    def prefill_time(self, l_q: int, l_kv: int = 0) -> float:
        """T~_p(r), Eq. (5) — excludes the constant batch overhead t_c."""
        return self.a_p * l_q * l_q + self.b_p * l_q * l_kv + self.c_p * l_q

    def decode_time(self, l_kv: int) -> float:
        """T~_d(r), Eq. (6)."""
        return self.a_d * l_kv + self.b_d

    def prefill_time_cached(self, prompt_len: int,
                            cached_tokens: int = 0) -> float:
        """Prefill cost after a prefix-cache hit: only the uncached suffix
        is computed, attending over the cached context (Eq. 5 with
        l_q = prompt - cached, l_kv = cached — the same decomposition that
        makes the estimator chunked-prefill compatible)."""
        l_q = max(prompt_len - cached_tokens, 0)
        return self.prefill_time(l_q, min(cached_tokens, prompt_len))

    def request_time(self, l_q: int, l_kv: int, is_prefill: bool) -> float:
        if is_prefill:
            return self.prefill_time(l_q, l_kv)
        return self.decode_time(l_kv + l_q)

    def reload_time(self, hot_blocks: int, cold_blocks: int,
                    t_block: float) -> float:
        """Tier-aware H2D reload estimate: hot (fp32) blocks cost a full
        ``t_block`` each, cold (int8) blocks only ``COLD_WIRE_RATIO`` of
        it — the copy-budget control (core/blocks.py, SlideBatching)
        uses this so cold-tier restores are priced by what actually
        crosses the wire.  ``cold_blocks == 0`` reproduces the legacy
        ``blocks * t_block`` bitwise."""
        return (hot_blocks + COLD_WIRE_RATIO * cold_blocks) * t_block

    def spec_overhead(self, l_kv, depth):
        """Extra cost of a depth-``depth`` verify launch over a plain
        decode of the same request: ``depth`` packed verify rows plus
        ``depth`` draft-model steps, both priced as ratios of
        T~_d(l_kv).  0 at depth 0 (bitwise: speculation off adds
        nothing).  Elementwise — scalars or numpy columns."""
        return ((VERIFY_ROW_RATIO + DRAFT_COST_RATIO) * depth
                * (self.a_d * l_kv + self.b_d))

    def spec_depth(self, l_kv: int, d_cap: int, rate: float) -> int:
        """Depth in [0, d_cap] maximizing expected accepted-tokens/s:
        expected_tokens(d, rate) / (T~_d + spec_overhead(d))."""
        from .spec import price_depth
        return price_depth(self.decode_time(l_kv),
                           lambda d: self.spec_overhead(l_kv, d),
                           d_cap, rate)

    def batch_time(self, items: Iterable[WorkItem]) -> float:
        """T(B), Eq. (7)."""
        coef = np.array([self.a_p, self.b_p, self.c_p,
                         self.a_d, self.b_d, self.t_c])
        return float(_features(items) @ coef)

    def batch_time_cols(self, l_q: Sequence[int], l_kv: Sequence[int],
                        is_prefill: Sequence[bool]) -> float:
        """``batch_time`` over pre-split columns (vectorized schedulers);
        bitwise identical to the tuple-list form."""
        coef = np.array([self.a_p, self.b_p, self.c_p,
                         self.a_d, self.b_d, self.t_c])
        f = _features_cols(np.asarray(l_q, np.float64),
                           np.asarray(l_kv, np.float64),
                           np.asarray(is_prefill, bool))
        return float(f @ coef)

    # --- fitting ----------------------------------------------------------
    @classmethod
    def fit(cls, batches: Sequence[Sequence[WorkItem]],
            latencies: Sequence[float], ridge: float = 1e-9,
            ) -> "BatchLatencyEstimator":
        """Least-squares fit (ridge-regularized, coefficients clipped >= 0)."""
        X = np.stack([_features(b) for b in batches])
        y = np.asarray(latencies, dtype=np.float64)
        # Normal equations with tiny ridge for conditioning; features span
        # ~10 orders of magnitude so whiten columns first.
        scale = np.maximum(np.abs(X).max(axis=0), 1e-30)
        Xs = X / scale
        A = Xs.T @ Xs + ridge * np.eye(X.shape[1])
        w = np.linalg.solve(A, Xs.T @ y) / scale
        w = np.maximum(w, 0.0)  # physical latencies are non-negative
        return cls(*w.tolist())

    def mape(self, batches: Sequence[Sequence[WorkItem]],
             latencies: Sequence[float]) -> float:
        preds = np.array([self.batch_time(b) for b in batches])
        y = np.asarray(latencies, dtype=np.float64)
        mask = y > 0
        return float(np.mean(np.abs(preds[mask] - y[mask]) / y[mask]))

    def as_dict(self) -> dict:
        return {k: getattr(self, k)
                for k in ("a_p", "b_p", "c_p", "a_d", "b_d", "t_c")}
