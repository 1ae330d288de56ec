"""A cell run end to end at smoke size on the CPU (the kernels' plain
versions), cells, mixes and a metric found by name in a copy that only
adds files, and the faults the check must catch."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from bench import harness
from bench.tests import smoke

SEED = 2**31 + 77          # seeds may exceed 32 bits


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return smoke.make(tmp_path_factory.mktemp("bench") / "checkout")


def run(copy, cell, trace=False, seed=SEED, **kw):
    return harness.run_cell(cell, seed, 2.0, trace, t_start=time.monotonic(),
                            device="cpu", root=copy,
                            log=lambda *a, **k: None, **kw)


def test_chat_cell_runs_end_to_end_and_is_correct(copy):
    res = run(copy, smoke.SMOKE_CHAT)
    assert res["check"]["correct"], res["check"]["numbers"]
    assert set(res["metrics"]) == {"tdg_ratio", "setup_s",
                                   "smoke.tokens_per_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    r = res["run"]
    assert len(r.measured) == 24 and not any(x.failed for x in r.measured)
    assert res["forbidden"] == []


def test_trace_run_reads_the_host_side_metrics_and_the_added_one(copy):
    res = run(copy, smoke.SMOKE_CHAT, trace=True)
    got = set(res["metrics"])
    # the device's metrics need the card's trace: silent on the CPU
    assert got == {"frontend.late_p95_ms", "sched.form_batch_ms",
                   "engine.step_ms", "engine.empty_step_ms",
                   "prefix.hit_share", "smoke.requests_due",
                   "driver.inbox_wait_p75_ms", "engine.queue_wait_p75_ms",
                   "sched.empty_round_share",
                   "model_exec.decode_graph_share"}
    assert res["metrics"]["smoke.requests_due"]["value"] == 24
    untraced = harness.info(run(copy, smoke.SMOKE_CHAT)["run"], res)
    assert set(untraced["per_layer_host"]) == got
    assert 0 < res["metrics"]["prefix.hit_share"]["value"] < 100


def test_same_seed_same_schedule_and_streams(copy):
    a, b = run(copy, smoke.SMOKE_CHAT), run(copy, smoke.SMOKE_CHAT)
    for x, y in zip(a["run"].recs, b["run"].recs):
        assert x.planned.due == y.planned.due
        assert (x.planned.prompt == y.planned.prompt).all()
        assert x.tokens == y.tokens


def test_moe_cell_runs_end_to_end_and_is_correct_under_the_routed_rule(
        copy):
    res = run(copy, smoke.SMOKE_MOE, seed=-SEED)    # any whole number
    chk = res["check"]
    assert chk["correct"], chk["numbers"]
    assert set(chk["numbers"]) == {"departing_share", "requests_checked",
                                   "tokens_checked", "overlong_streams"}
    assert set(res["metrics"]) == {"tdg_ratio", "setup_s"}
    r = res["run"]
    assert r.arch.family == "moe" and r.arch.top_k == 2
    assert len(r.measured) == 24 and not any(x.failed for x in r.measured)
    assert r.counters["decode_graph_captures"] == 0   # the CPU never
    assert r.counters["decode_launches"] > 0          # captures


FAULTS = ["token_altered", "state_unchanged", "half_batch"]
# a program that leaves out part of the routing
ROUTED_FAULTS = ["top_k_minus_one", "gates_over_all_experts",
                 "expert_zeroed"]


def _break(monkeypatch, fault):
    from repro_torch.models import moe
    from repro_torch.serving import engine as eng_mod
    from repro_torch.serving import model_exec
    if fault == "top_k_minus_one":
        fwd = moe.moe_forward

        def fewer(x, p, top_k, *a, **k):
            return fwd(x, p, top_k - 1, *a, **k)
        monkeypatch.setattr(moe, "moe_forward", fewer)
    elif fault == "gates_over_all_experts":
        route = moe.route

        def unnormalised(x, p, top_k, capacity_factor=1.25):
            r = route(x, p, top_k, capacity_factor)
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
            return r._replace(gates=probs.gather(-1, r.idx))
        monkeypatch.setattr(moe, "route", unnormalised)
    elif fault == "expert_zeroed":
        experts = moe._swiglu_e

        def lost(h, *w):
            y = experts(h, *w).clone()
            y[0] = 0
            return y
        monkeypatch.setattr(moe, "_swiglu_e", lost)
    elif fault == "token_altered":
        emit = eng_mod.Engine._emit

        def bad_emit(self, r, tok, emitted):
            emit(self, r, (tok + 1) % self.cfg.vocab if r.generated % 3 == 1
                 else tok, emitted)
        monkeypatch.setattr(eng_mod.Engine, "_emit", bad_emit)
    elif fault == "state_unchanged":
        step = model_exec.decode_step

        def no_write(cfg, params, pool_kv, *a):
            toks, _ = step(cfg, params, pool_kv.clone(), *a)
            return toks, pool_kv
        monkeypatch.setattr(model_exec, "decode_step", no_write)
    else:
        step = model_exec.decode_step

        def half(cfg, params, pool_kv, tokens, tables, lens):
            toks, pool = step(cfg, params, pool_kv, tokens, tables, lens)
            n = int((lens > 0).sum())
            toks = toks.clone()
            toks[n // 2:n] = toks[0]
            return toks, pool
        monkeypatch.setattr(model_exec, "decode_step", half)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(copy, monkeypatch, fault):
    _break(monkeypatch, fault)
    res = run(copy, smoke.SMOKE_CHAT)
    nums = res["check"]["numbers"]
    assert not res["check"]["correct"]
    assert not nums["max_logit_gap"]["holds"], nums


@pytest.mark.parametrize("fault", FAULTS + ROUTED_FAULTS)
def test_a_broken_routed_path_is_not_correct(copy, monkeypatch, fault):
    _break(monkeypatch, fault)
    res = run(copy, smoke.SMOKE_MOE)
    nums = res["check"]["numbers"]
    assert not res["check"]["correct"]
    assert not nums["departing_share"]["holds"], nums


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(smoke.ROOT / "bench" / "run.py"),
                        "--workload", smoke.CHAT, "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_refuses_without_the_program(tmp_path):
    (tmp_path / "bench").mkdir()
    import shutil
    shutil.copytree(smoke.ROOT / "bench", tmp_path / "bench",
                    dirs_exist_ok=True)
    shutil.copy(smoke.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        smoke.CHAT, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        smoke.CHAT, "--seed", str(SEED), "--seconds", "5",
                        "--trace", "0"], cwd=smoke.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
