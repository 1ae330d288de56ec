"""The one traffic generator: every mix is a JSON file under
``bench/traffic/`` that this module reads.

Arrivals are an open loop at a fixed rate.  The schedule has three
segments on the window's clock: the ramp ``[-ramp_s, 0)``, the window
``[0, seconds)`` and the drain ``[seconds, seconds + drain_limit_s)``,
whose arrivals keep the load steady until every request due in the
window has finished.  Each segment holds ``round(rate * length)`` requests
whose sizes, classes, shared-prefix flags and inter-arrival gaps are the
same multiset for every seed, drawn by stratified quantiles of the mix's
distributions (lognormal lengths, exponential gaps: a Poisson process);
the seed only permutes them and draws the token ids.  So two seeds load
the card with the same work in another order, and a run's spread is the
system's, not the sampler's.

The lognormal is parameterised by its mean, as ``repro_torch.sim.
workloads._lognormal_lengths`` does (copied here, frozen): ``mu =
ln(mean) - sigma**2 / 2``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

_PHI_INV = NormalDist().inv_cdf


@dataclasses.dataclass(frozen=True)
class Planned:
    """One request of the schedule.  ``due`` is seconds on the window's
    clock (0 = window start); ``segment`` is "ramp", "window" or
    "after"."""
    idx: int
    due: float
    segment: str
    prompt: np.ndarray            # int32 token ids
    output_len: int
    priority: int
    weight: float
    ttft_s: float
    tpot_s: float
    prefix: int                   # shared system prompt id, -1 for none

    @property
    def measured(self) -> bool:
        return self.segment == "window"


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    shares = sum(c["share"] for c in mix["classes"])
    if abs(shares - 1.0) > 1e-9:
        raise ValueError(f"{path}: class shares sum to {shares}, not 1")
    return mix


def lognormal_quantiles(n: int, mean: float, sigma: float, lo: int,
                        hi: int) -> np.ndarray:
    """The n stratified quantiles ``(i + 0.5) / n`` of the lognormal with
    this mean, clipped to [lo, hi] and cut to whole tokens."""
    mu = math.log(mean) - sigma * sigma / 2.0
    u = (np.arange(n) + 0.5) / n
    v = np.exp(mu + sigma * np.array([_PHI_INV(x) for x in u]))
    return np.clip(v, lo, hi).astype(np.int64)


def exact_counts(n: int, shares: list) -> list:
    """n split by shares, largest remainders first (ties to the first)."""
    raw = [n * s for s in shares]
    counts = [int(math.floor(x)) for x in raw]
    order = sorted(range(len(shares)), key=lambda i: (counts[i] - raw[i], i))
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return counts


def _segment(n: int, start: float, length: float, mix: dict,
             rng: np.random.Generator) -> list:
    """(due, prompt_len, output_len, class index, has prefix) of one
    segment, in due order.  The requests themselves (the pairing of sizes,
    classes and prefix flags) are fixed by ``n`` alone; the seed's ``rng``
    orders them and the gaps between them."""
    if n == 0:
        return []
    fixed = np.random.default_rng(n)
    pt, ot = mix["prompt_tokens"], mix["output_tokens"]
    plens = fixed.permutation(lognormal_quantiles(
        n, pt["mean"], pt["sigma"], pt["min"], pt["max"]))
    olens = fixed.permutation(lognormal_quantiles(
        n, ot["mean"], ot["sigma"], ot["min"], ot["max"]))
    cls = np.repeat(np.arange(len(mix["classes"])),
                    exact_counts(n, [c["share"] for c in mix["classes"]]))
    cls = fixed.permutation(cls)
    sp = mix.get("shared_prefixes")
    n_pre = int(round(n * sp["share"])) if sp else 0
    has_pre = fixed.permutation(np.arange(n) < n_pre)
    order = rng.permutation(n)
    # exponential quantiles: the gaps of a Poisson process, permuted and
    # scaled so the segment spans exactly its length
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u))
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) / gaps.sum()
    return [(start + length * float(t[k]), int(plens[i]), int(olens[i]),
             int(cls[i]), bool(has_pre[i])) for k, i in enumerate(order)]


def entropy(seed: int) -> int:
    """Any whole number as numpy's seed: a non-negative one as it is, a
    negative one as ``weights.seed_int`` takes it."""
    seed = int(seed)
    return seed if seed >= 0 else seed % (1 << 63)


def schedule(mix: dict, seconds: float, vocab: int, seed: int) -> list:
    """The run's requests in due order, with their prompts."""
    rng = np.random.default_rng(entropy(seed))
    rate = float(mix["rate_per_s"])
    segs = [("ramp", -float(mix["ramp_s"]), float(mix["ramp_s"])),
            ("window", 0.0, float(seconds)),
            ("after", float(seconds), float(mix["drain_limit_s"]))]
    sp = mix.get("shared_prefixes")
    prefixes = ([rng.integers(1, vocab, sp["tokens"], dtype=np.int64)
                 .astype(np.int32) for _ in range(sp["count"])]
                if sp else [])
    out = []
    for name, start, length in segs:
        for due, plen, olen, ci, pre in _segment(
                int(round(rate * length)), start, length, mix, rng):
            c = mix["classes"][ci]
            pid = -1
            if pre:
                pid = int(rng.integers(0, len(prefixes)))
                plen = max(plen, sp["min_prompt"])
            prompt = rng.integers(1, vocab, plen, dtype=np.int64).astype(
                np.int32)
            if pre:
                prompt[:sp["tokens"]] = prefixes[pid]
            out.append(Planned(len(out), due, name, prompt, olen,
                               int(c["priority"]), float(c["weight"]),
                               float(c["ttft_s"]), float(c["tpot_s"]), pid))
    out.sort(key=lambda p: (p.due, p.idx))
    return out


def warmup_set(mix: dict, vocab: int, seed: int) -> list:
    """(prompt, output_len) pairs for set-up's warm-up: the mix's longest
    and shortest prompts and a few mid-sized ones, at short outputs, from
    the seed (the same work for every seed)."""
    rng = np.random.default_rng([entropy(seed), 1])
    pt = mix["prompt_tokens"]
    w = mix["warmup"]
    lens = [pt["max"], pt["min"]] + [int(pt["mean"])] * (w["requests"] - 2)
    return [(rng.integers(1, vocab, n, dtype=np.int64).astype(np.int32),
             int(w["output_tokens"])) for n in lens]
