"""The generator and the arithmetic the benchmark keeps frozen."""
from __future__ import annotations

import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from bench import cost, traffic, yardstick

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


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 77, 2**63 - 1, 2**64 + 3])
def test_every_non_negative_seed_keeps_its_schedule(seed, monkeypatch):
    m = traffic.load(MIXES / "chat.json")
    now = traffic.schedule(m, 10.0, 1000, seed)
    warm = traffic.warmup_set(m, 1000, seed)
    # numpy took the seed as it was before any whole number was taken
    monkeypatch.setattr(traffic, "entropy", lambda s: s)
    then = traffic.schedule(m, 10.0, 1000, seed)
    assert [p.due for p in now] == [p.due for p in then]
    assert all((x.prompt == y.prompt).all() for x, y in zip(now, then))
    assert all((x == y).all() and a == b for (x, a), (y, b)
               in zip(warm, traffic.warmup_set(m, 1000, seed)))


def test_a_negative_seed_gives_the_same_work_in_another_order():
    m = traffic.load(MIXES / "chat.json")
    a = traffic.schedule(m, 10.0, 1000, -(2**31 + 77))
    b = traffic.schedule(m, 10.0, 1000, -(2**31 + 77))
    assert [p.due for p in a] == [p.due for p in b]
    assert Counter((len(p.prompt), p.output_len) for p in a) == Counter(
        (len(p.prompt), p.output_len) for p in traffic.schedule(
            m, 10.0, 1000, 5))
    assert len(traffic.warmup_set(m, 1000, -3)) == m["warmup"]["requests"]


def _arch(name):
    from repro_torch.configs import get
    return get(name)


def test_dense_layer_params_are_unchanged():
    # attention 3584 x 128 x (28 + 2 x 4) + 28 x 128 x 3584, SwiGLU
    # 3 x 3584 x 18944: the count before routed layers were counted
    assert cost.layer_params(_arch("qwen2_7b")) == 233046016


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "qwen2_moe_a2_7b"])
def test_routed_layer_params_are_the_active_count(name):
    a = _arch(name)
    assert a.n_layers * cost.layer_params(a) + 2 * a.vocab * a.d_model \
        == a.active_param_count()


def test_moe_ffn_counts_the_routed_work_and_the_experts_it_reads():
    a = _arch("olmoe_1b_7b")
    d, f, E = a.d_model, a.d_expert, a.n_experts
    flops, bytes_ = cost.moe_ffn(a, 10, 30)
    assert flops == 2 * 10 * (d * E + a.top_k * 3 * d * f)
    assert bytes_ == 4 * (d * E + 30 * 3 * d * f + 2 * 10 * d)
    # one token reads its own experts: the bound is a weight read, not
    # all 64 experts
    one = cost.moe_ffn(a, 1, a.top_k)
    assert cost.bound_s(*one, {"fp32_flops_per_s": 165e12,
                               "bytes_per_s": 3.35e12}) == pytest.approx(
        one[1] / 3.35e12)
    q = _arch("qwen2_moe_a2_7b")
    shared = 3 * q.d_model * q.n_shared * q.d_expert
    assert cost.moe_ffn(q, 1, 0)[1] == 4 * (q.d_model * q.n_experts
                                            + shared + 2 * q.d_model)


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
