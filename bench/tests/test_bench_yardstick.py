"""The generator and the arithmetic the benchmark keeps frozen."""
from __future__ import annotations

import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from bench import traffic, yardstick

MIXES = Path(__file__).resolve().parents[1] / "traffic"


@pytest.mark.parametrize("mix", ["chat"])
def test_schedule_is_deterministic_per_seed(mix):
    m = traffic.load(MIXES / f"{mix}.json")
    a = traffic.schedule(m, 10.0, 1000, 2**33 + 1)
    b = traffic.schedule(m, 10.0, 1000, 2**33 + 1)
    c = traffic.schedule(m, 10.0, 1000, 2**33 + 2)
    assert [p.due for p in a] == [p.due for p in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))
    assert [p.due for p in a] != [p.due for p in c]


@pytest.mark.parametrize("mix", ["chat"])
def test_every_seed_gets_the_same_work_in_the_window(mix):
    m = traffic.load(MIXES / f"{mix}.json")

    def work(seed):
        s = traffic.schedule(m, 20.0, 1000, seed)
        return Counter((len(p.prompt), p.output_len, p.priority,
                        p.prefix >= 0) for p in s if p.measured)
    assert work(1) == work(2**32 + 9)
    n = sum(work(1).values())
    assert n == round(m["rate_per_s"] * 20.0)


def test_window_arrivals_span_the_window_at_the_rate():
    m = traffic.load(MIXES / "chat.json")
    s = [p for p in traffic.schedule(m, 30.0, 1000, 5) if p.measured]
    dues = np.array([p.due for p in s])
    assert dues.min() == 0.0 and dues.max() < 30.0
    gaps = np.diff(np.sort(dues))
    assert abs(gaps.mean() - 30.0 / len(s)) < 0.05 * 30.0 / len(s)
    shares = Counter(p.priority for p in s)
    assert shares == Counter({1: round(0.2 * len(s)),
                              2: round(0.35 * len(s)),
                              3: len(s) - round(0.2 * len(s))
                              - round(0.35 * len(s))})


def test_shared_prefixes_open_the_prompts_that_have_them():
    m = traffic.load(MIXES / "chat.json")
    s = traffic.schedule(m, 20.0, 1000, 3)
    sp = m["shared_prefixes"]
    heads = {}
    for p in s:
        if p.prefix >= 0:
            assert len(p.prompt) >= sp["min_prompt"]
            heads.setdefault(p.prefix, p.prompt[:sp["tokens"]].tobytes())
            assert heads[p.prefix] == p.prompt[:sp["tokens"]].tobytes()
    assert len(heads) == sp["count"]


def test_lognormal_quantiles_have_the_mixes_mean_before_clipping():
    q = traffic.lognormal_quantiles(20000, 512, 0.9, 1, 10**9)
    assert abs(q.mean() / 512 - 1) < 0.01


class R:
    def __init__(self, arrival, ttft, tpot, weight, out, n, failed=False):
        self.arrival, self.ttft_s, self.tpot_s = arrival, ttft, tpot
        self.weight, self.out_times, self.output_len = weight, out, n
        self.failed = failed


def test_tdg_matches_the_programs_arithmetic():
    from repro_torch.core.request import SLO, Request
    from repro_torch.core.tdg import tdg_ratio
    rng = np.random.default_rng(0)
    ours, theirs = [], []
    for _ in range(50):
        n = int(rng.integers(1, 60))
        a, ttft, tpot = rng.random(), 0.5, 0.05
        t = np.sort(a + rng.random() + np.cumsum(rng.random(n) * 0.08))
        w = float(rng.choice([1.0, 2.0, 3.0]))
        ours.append(R(a, ttft, tpot, w, list(t), n))
        r = Request(prompt_len=8, output_len=n, arrival=a,
                    slo=SLO(ttft, tpot), weight=w)
        for x in t:
            r.emit_token(float(x))
        theirs.append(r)
    assert yardstick.tdg_ratio(ours, w_p=4.0) == pytest.approx(
        tdg_ratio(theirs, w_p=4.0), rel=1e-12)


def test_a_failed_request_adds_only_its_ideal():
    ok = R(0.0, 1.0, 1.0, 1.0, [0.1, 0.2], 2)
    bad = R(0.0, 1.0, 1.0, 1.0, [0.1], 2, failed=True)
    assert yardstick.tdg_ratio([ok, bad], w_p=4.0) == pytest.approx(0.5)


def test_percentile_ranks_failed_requests_last():
    v = list(np.linspace(0, 1, 99))
    assert yardstick.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert yardstick.percentile(v + [math.inf] * 10, 95) == math.inf
    assert yardstick.finite_or(math.inf, 7.0) == 7.0
