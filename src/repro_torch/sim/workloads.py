"""Workload generators: synthetic facsimiles of the paper's five datasets.

Real ShareGPT / Azure / BurstGPT / QwenTrace / industrial traces are not
available offline, so each generator reproduces the published *shape* of its
namesake (length distributions, arrival burstiness, priority mix) with a
seeded RNG — see DESIGN.md §7.  All experiments report results on these
facsimiles and validate relative claims.

Priorities follow §5.1: requests are high/low with 50 % probability and
weights (2, 1) by default; the industrial workload uses 3 classes with
phase-shifted diurnal load (Fig. 1) and business-value weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..core.request import Request, SLO


@dataclass
class WorkloadSpec:
    name: str
    mean_in: float
    mean_out: float
    ttft_slo: float = 2.0        # s
    tpot_slo: float = 0.1        # s
    priorities: tuple = (1, 2)
    weights: tuple = (2.0, 1.0)
    prio_probs: tuple = (0.5, 0.5)
    # optional per-request SLO classes [(ttft, tpot), ...] with probs —
    # heterogeneous-SLO workloads (multi-SLO motivation studies, §3.2)
    slo_classes: Optional[tuple] = None
    slo_probs: Optional[tuple] = None


def _lognormal_lengths(rng, mean, sigma, lo, hi, n):
    mu = math.log(mean) - sigma * sigma / 2.0
    v = np.exp(rng.normal(mu, sigma, size=n))
    return np.clip(v, lo, hi).astype(int)


def _assign_priority(rng, spec: WorkloadSpec, n):
    idx = rng.choice(len(spec.priorities), size=n, p=spec.prio_probs)
    prio = np.array(spec.priorities)[idx]
    wts = np.array(spec.weights)[idx]
    return prio, wts


def _build(arrivals, in_lens, out_lens, prio, wts, spec,
           clients: Optional[np.ndarray] = None,
           rng: Optional[np.random.Generator] = None) -> list[Request]:
    reqs = []
    rng = rng or np.random.default_rng(0)
    for i, t in enumerate(arrivals):
        if spec.slo_classes:
            k = rng.choice(len(spec.slo_classes), p=spec.slo_probs)
            slo = SLO(*spec.slo_classes[k])
        else:
            slo = SLO(spec.ttft_slo, spec.tpot_slo)
        reqs.append(Request(
            prompt_len=int(in_lens[i]), output_len=max(1, int(out_lens[i])),
            arrival=float(t), slo=slo,
            priority=int(prio[i]), weight=float(wts[i]),
            client=int(clients[i]) if clients is not None else int(prio[i])))
    return reqs


# --------------------------------------------------------------------------

def sharegpt(rate: float, duration: float, seed: int = 0,
             spec: Optional[WorkloadSpec] = None) -> list[Request]:
    """ShareGPT-like: conversational, moderate prompts, Poisson arrivals
    (the paper uses Poisson for datasets without timestamps)."""
    spec = spec or WorkloadSpec("sharegpt", mean_in=280, mean_out=230)
    rng = np.random.default_rng(seed)
    n = max(1, int(rate * duration * 1.2))
    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    n = len(arrivals)
    in_lens = _lognormal_lengths(rng, spec.mean_in, 0.9, 8, 4096, n)
    out_lens = _lognormal_lengths(rng, spec.mean_out, 0.9, 4, 2048, n)
    prio, wts = _assign_priority(rng, spec, n)
    return _build(arrivals, in_lens, out_lens, prio, wts, spec, rng=rng)


def azure(rate: float, duration: float, seed: int = 0,
          spec: Optional[WorkloadSpec] = None) -> list[Request]:
    """Azure-LLM-inference-like: mix of short chat and long code prompts,
    heavier-tailed lengths, timestamps replayed after rate scaling."""
    spec = spec or WorkloadSpec("azure", mean_in=1024, mean_out=190)
    rng = np.random.default_rng(seed)
    n = max(1, int(rate * duration * 1.2))
    # mildly bursty: gamma(k=0.6) inter-arrivals scaled to the target rate
    gaps = rng.gamma(0.6, 1.0 / (0.6 * rate), size=n)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    n = len(arrivals)
    is_code = rng.random(n) < 0.4
    in_lens = np.where(is_code,
                       _lognormal_lengths(rng, 2048, 0.8, 64, 8192, n),
                       _lognormal_lengths(rng, 512, 0.9, 8, 4096, n))
    out_lens = np.where(is_code,
                        _lognormal_lengths(rng, 60, 0.8, 4, 512, n),
                        _lognormal_lengths(rng, 280, 0.8, 4, 2048, n))
    prio, wts = _assign_priority(rng, spec, n)
    return _build(arrivals, in_lens, out_lens, prio, wts, spec, rng=rng)


def burstgpt(rate: float, duration: float, seed: int = 0,
             spec: Optional[WorkloadSpec] = None) -> list[Request]:
    """BurstGPT-like: pronounced request bursts (KDD'25 trace character)."""
    spec = spec or WorkloadSpec("burstgpt", mean_in=400, mean_out=250)
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while t < duration:
        burst = rng.random() < 0.15
        k = int(rng.integers(6, 24)) if burst else 1
        for _ in range(k):
            arrivals.append(t + rng.random() * 0.05)
        t += rng.exponential(max(k, 1) / rate)
    arrivals = np.sort(np.array([a for a in arrivals if a < duration]))
    n = len(arrivals)
    in_lens = _lognormal_lengths(rng, spec.mean_in, 1.0, 8, 6144, n)
    out_lens = _lognormal_lengths(rng, spec.mean_out, 0.9, 4, 2048, n)
    prio, wts = _assign_priority(rng, spec, n)
    return _build(arrivals, in_lens, out_lens, prio, wts, spec, rng=rng)


def qwentrace(rate: float, duration: float, seed: int = 0,
              spec: Optional[WorkloadSpec] = None) -> list[Request]:
    """QwenTrace-like: very high request-length variance (the property that
    makes GoRouting shine, §5.2) + prefix-cache-like short-context hits."""
    spec = spec or WorkloadSpec("qwentrace", mean_in=1500, mean_out=300)
    rng = np.random.default_rng(seed)
    n = max(1, int(rate * duration * 1.2))
    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    n = len(arrivals)
    bucket = rng.choice(3, size=n, p=[0.5, 0.35, 0.15])
    in_lens = np.select(
        [bucket == 0, bucket == 1, bucket == 2],
        [_lognormal_lengths(rng, 180, 0.7, 8, 1024, n),
         _lognormal_lengths(rng, 2200, 0.6, 256, 16384, n),
         _lognormal_lengths(rng, 9000, 0.5, 2048, 32768, n)])
    out_lens = _lognormal_lengths(rng, spec.mean_out, 1.0, 4, 2048, n)
    prio, wts = _assign_priority(rng, spec, n)
    return _build(arrivals, in_lens, out_lens, prio, wts, spec, rng=rng)


def industrial(rate: float, duration: float, seed: int = 0,
               spec: Optional[WorkloadSpec] = None) -> list[Request]:
    """Industrial-like (Fig. 1): three priority classes with distinct,
    phase-shifted diurnal load patterns and business-value weights."""
    spec = spec or WorkloadSpec("industrial", mean_in=600, mean_out=220,
                                priorities=(1, 2, 3), weights=(4.0, 2.0, 1.0),
                                prio_probs=(0.2, 0.35, 0.45))
    rng = np.random.default_rng(seed)
    reqs: list[Request] = []
    period = max(duration, 1e-9)
    # per-class sinusoidal intensity with phase shifts (Fig. 1 shape)
    phases = {1: 0.0, 2: 2.1, 3: 4.2}
    for ci, p in enumerate(spec.priorities):
        lam = rate * spec.prio_probs[ci]
        t = 0.0
        while t < duration:
            intensity = lam * (1.0 + 0.7 * math.sin(
                2 * math.pi * t / period + phases[p]))
            t += rng.exponential(1.0 / max(intensity, 0.05 * lam))
            if t < duration:
                in_len = int(_lognormal_lengths(rng, spec.mean_in, 0.9,
                                                8, 8192, 1)[0])
                out_len = int(_lognormal_lengths(rng, spec.mean_out, 0.9,
                                                 4, 2048, 1)[0])
                reqs.append(Request(
                    prompt_len=in_len, output_len=out_len, arrival=t,
                    slo=SLO(spec.ttft_slo, spec.tpot_slo),
                    priority=p, weight=spec.weights[ci], client=p))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


def shared_prefix(rate: float, duration: float, seed: int = 0,
                  spec: Optional[WorkloadSpec] = None, *,
                  n_groups: int = 4, prefix_len: int = 512,
                  p_shared: float = 0.8,
                  suffix_mean: float = 96.0) -> list[Request]:
    """Shared-system-prompt workload (multi-turn chat / agent loops /
    few-shot templates): a ``p_shared`` fraction of requests draws one of
    ``n_groups`` common system prompts of ``prefix_len`` tokens followed by
    a unique lognormal suffix; the rest are fully unique.  Requests are
    stamped with ``prefix_group`` / ``shared_prefix_len`` so the simulator
    can model cache hits and the trace replayer can synthesize
    byte-identical prefixes for the real radix cache."""
    spec = spec or WorkloadSpec("shared_prefix", mean_in=prefix_len + 96,
                                mean_out=160)
    rng = np.random.default_rng(seed)
    n = max(1, int(rate * duration * 1.2))
    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    n = len(arrivals)
    shared = rng.random(n) < p_shared
    groups = rng.integers(0, n_groups, size=n)
    suffix = _lognormal_lengths(rng, suffix_mean, 0.8, 8, 2048, n)
    in_lens = np.where(shared, prefix_len + suffix,
                       _lognormal_lengths(rng, spec.mean_in, 0.9, 8, 4096, n))
    out_lens = _lognormal_lengths(rng, spec.mean_out, 0.9, 4, 1024, n)
    prio, wts = _assign_priority(rng, spec, n)
    reqs = _build(arrivals, in_lens, out_lens, prio, wts, spec, rng=rng)
    for i, r in enumerate(reqs):
        if shared[i]:
            r.prefix_group = int(groups[i])
            r.shared_prefix_len = prefix_len
    return reqs


SCALE_SPEC = WorkloadSpec("scale_mix", mean_in=360, mean_out=64,
                          priorities=(1, 2, 3), weights=(4.0, 2.0, 1.0),
                          prio_probs=(0.2, 0.35, 0.45))

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 step: the standard 64-bit finalizer, used to derive
    statistically independent per-chunk RNG seeds from (seed, chunk)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M64


def _chunk_seed(seed: int, chunk_index: int) -> int:
    return _splitmix64(_splitmix64(seed & _M64) ^ chunk_index)


class _ChunkBufs:
    """Preallocated per-chunk scratch arrays for ``iter_scale_trace``.

    Profiling the 10⁵ replay showed the generator's allocation churn
    (fresh exponential/lognormal/choice arrays every chunk) as a steady
    background cost; these buffers are allocated once and refilled in
    place each chunk (``Generator.random``/``standard_normal`` support
    ``out=``), so steady-state generation allocates only the ``Request``
    objects themselves."""

    __slots__ = ("u", "f", "arrivals", "in_len", "out_len", "prio", "wts")

    def __init__(self, chunk: int):
        self.u = np.empty(chunk)
        self.f = np.empty(chunk)
        self.arrivals = np.empty(chunk)
        self.in_len = np.empty(chunk, np.int64)
        self.out_len = np.empty(chunk, np.int64)
        self.prio = np.empty(chunk, np.int64)
        self.wts = np.empty(chunk)


def _lognormal_into(rng, mean: float, sigma: float, lo: int, hi: int,
                    scratch: np.ndarray, out: np.ndarray, k: int) -> None:
    """In-place ``_lognormal_lengths``: fill ``out[:k]`` reusing
    ``scratch[:k]`` as the float workspace."""
    mu = math.log(mean) - sigma * sigma / 2.0
    s = scratch[:k]
    rng.standard_normal(out=s)
    np.multiply(s, sigma, out=s)
    np.add(s, mu, out=s)
    np.exp(s, out=s)
    np.clip(s, lo, hi, out=s)
    out[:k] = s            # float -> int64 truncation, as .astype(int) did


def iter_scale_trace(n_requests: int, *, rate: float = 200.0, seed: int = 0,
                     spec: Optional[WorkloadSpec] = None, chunk: int = 8192,
                     start_chunk: int = 0):
    """Streaming 10⁵–10⁶-request trace generator (docs/WORKLOADS.md).

    Yields exactly ``n_requests`` 3-priority requests in arrival order
    (lognormal lengths, mean arrival rate ``rate``/s) while holding only
    ``chunk`` requests' worth of RNG output at a time — pair it with
    ``ClusterSim.run_stream`` for constant-memory replay.

    Chunks are INDEPENDENT: chunk ``c`` draws from its own
    ``default_rng(splitmix64(seed, c))`` and covers the fixed trace-time
    span ``[c*chunk/rate, c*chunk/rate + k/rate)`` with ``k`` sorted
    uniform arrivals (the order statistics of a rate-conditioned Poisson
    process), so any consumer — a sharded worker, a partitioned metrics
    test, a resumed generator — can regenerate chunk ``c`` without
    replaying chunks ``0..c-1`` (``start_chunk`` skips straight to it).
    The tuple ``(n_requests, rate, seed, spec, chunk)`` fully determines
    the trace; a different ``chunk`` is a DIFFERENT trace — treat it as
    part of the trace identity.  Scratch buffers are preallocated once
    and reused across chunks (see ``_ChunkBufs``).
    """
    spec = spec or SCALE_SPEC
    bufs = _ChunkBufs(chunk)
    cum_probs = np.cumsum(spec.prio_probs)
    prios = np.asarray(spec.priorities, np.int64)
    weights = np.asarray(spec.weights)
    c = start_chunk
    while c * chunk < n_requests:
        k = min(chunk, n_requests - c * chunk)
        rng = np.random.default_rng(_chunk_seed(seed, c))
        span_start = c * (chunk / rate)
        u = bufs.u[:k]
        rng.random(out=u)
        u.sort()
        arrivals = bufs.arrivals[:k]
        np.multiply(u, k / rate, out=arrivals)
        np.add(arrivals, span_start, out=arrivals)
        _lognormal_into(rng, spec.mean_in, 0.9, 8, 4096,
                        bufs.f, bufs.in_len, k)
        _lognormal_into(rng, spec.mean_out, 0.9, 4, 512,
                        bufs.f, bufs.out_len, k)
        rng.random(out=u)      # arrivals already copied out of bufs.u
        idx = np.searchsorted(cum_probs, u, side="right")
        np.clip(idx, 0, len(prios) - 1, out=idx)
        np.take(prios, idx, out=bufs.prio[:k])
        np.take(weights, idx, out=bufs.wts[:k])
        yield from _build(arrivals, bufs.in_len, bufs.out_len,
                          bufs.prio, bufs.wts, spec, rng=rng)
        c += 1


def scale_mix(rate: float, duration: float, seed: int = 0,
              spec: Optional[WorkloadSpec] = None) -> list[Request]:
    """List-form ``iter_scale_trace`` wrapper taking the same
    ``(rate, duration, seed)`` arguments as the ``WORKLOADS`` generators
    (``n = rate * duration`` requests).

    Count-sized: the last arrivals routinely land past ``duration``
    (Poisson gaps, fixed n), so this is NOT in the ``WORKLOADS``
    registry, whose contract bounds arrivals to ``[0, duration)``.
    Use ``--n-requests`` in the replay CLI instead of ``--workload``.
    """
    n = max(1, int(rate * duration))
    return list(iter_scale_trace(n, rate=rate, seed=seed, spec=spec))


WORKLOADS: dict[str, Callable] = {
    "sharegpt": sharegpt,
    "azure": azure,
    "burstgpt": burstgpt,
    "qwentrace": qwentrace,
    "industrial": industrial,
    "shared_prefix": shared_prefix,
}
