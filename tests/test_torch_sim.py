"""The port's simulator (``repro_torch.sim``) against the JAX package's
(``repro.sim``): the same traces through both give identical per-request
token times, report rows (all but ``wall_s``) and counters — ``EngineSim``
under every policy, ``ClusterSim`` colocated, disaggregated, with a kill
and with elastic scale-up, ``VectorClusterSim``, ``WindowedClusterSim``
and the sharded replay — on the fixtures of ``tests/test_sim_and_service.py``,
``test_vector_sim.py``, ``test_windowed_sim.py`` and ``test_shard_merge.py``;
``tests/test_system.py``'s two scenarios on the port's simulator; the
default TPU v5e executor bit for bit the reference's; the H100 hardware
object changing only the constants it names; and the launcher's
``--mode sim`` cell equal to the reference's."""
import dataclasses
import importlib
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def pkg(name: str) -> SimpleNamespace:
    imp = importlib.import_module
    return SimpleNamespace(
        name=name, core=imp(f"{name}.core"), sim=imp(f"{name}.sim"),
        slide=imp(f"{name}.core.slidebatching"),
        workloads=imp(f"{name}.sim.workloads"))


REF, PORT = pkg("repro"), pkg("repro_torch")
_EXEC: dict = {}


def exec_est(m):
    """QWEN2_7B on 4 v5e chips, the estimator fitted on 200 batches."""
    if m.name not in _EXEC:
        ex = m.sim.AnalyticalExecutor(m.sim.QWEN2_7B,
                                      m.sim.InstanceHardware(chips=4))
        est, _ = ex.fit_estimator(n=200)
        _EXEC[m.name] = (ex, est)
    return _EXEC[m.name]


def pinned(reqs):
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def signature(reqs):
    return [(r.rid, tuple(r.out_times), r.finish_time, r.preemptions)
            for r in reqs]


def row(rep) -> dict:
    return {k: v for k, v in rep.row().items() if k != "wall_s"}


def cluster(m, *, cls="ClusterSim", router="gorouting", pd_mode="coloc",
            policy=None, spec_k=0, **ccfg):
    ex, est = exec_est(m)
    rt = (m.core.GoRouting(est, m.core.RouterConfig(pd_mode=pd_mode))
          if router == "gorouting" else m.core.MinLoad(est))
    return getattr(m.sim, cls)(
        policy or (lambda: m.core.make_policy("slidebatching")), rt, ex,
        est, m.core.EngineConfig(w_p=4.0, spec_k=spec_k),
        m.sim.ClusterConfig(pd_mode=pd_mode, **ccfg))


def cluster_counters(cs) -> dict:
    keys = ("handoffs", "handoff_blocks", "handoff_bytes",
            "reservation_hits", "reservation_misses",
            "reserved_blocks_total", "adopted_blocks_total",
            "spec_proposed", "spec_accepted", "spec_rejected")
    out = {k: getattr(cs, k) for k in keys}
    out["spec_depth_hist"] = cs.spec_depth_hist
    out["engines"] = {iid: (e.iterations, e.prefill_tokens)
                      for iid, e in [*cs.engines.items(),
                                     *cs.decode_engines.items()]}
    out["dropped"] = sorted(r.rid for r in cs.dropped)
    return out


# ---------------------------------------------------------------------------
# scenarios: each runs one package's simulator, returns what must agree
# ---------------------------------------------------------------------------

def drive_single(engine, reqs):
    """``tests/test_sim_and_service.py``'s single-engine driver."""
    pending = sorted(reqs, key=lambda r: r.arrival)
    now, i, guard = 0.0, 0, 0
    while (i < len(pending) or engine.has_work()) and guard < 100000:
        guard += 1
        while i < len(pending) and pending[i].arrival <= now:
            engine.add_request(pending[i], now)
            i += 1
        res = engine.step(now)
        if res is None:
            if i < len(pending):
                now = pending[i].arrival
            else:
                break
        else:
            now = res.end
    return reqs


def engine_sim(policy):
    def run(m):
        ex, est = exec_est(m)
        reqs = pinned(m.workloads.sharegpt(rate=20, duration=5, seed=2))
        eng = m.sim.EngineSim(0, m.core.make_policy(policy), ex, est,
                              m.core.EngineConfig(w_p=4.0))
        drive_single(eng, reqs)
        return (signature(reqs), m.sim.summarize(reqs, w_p=4.0).row(),
                eng.iterations, eng.prefill_tokens)
    return run


def sharegpt_cluster(seed, rate=30, kills=None, scale_ups=None, **kw):
    def run(m):
        cs = cluster(m, **kw)
        reqs = pinned(m.workloads.sharegpt(rate=rate, duration=4,
                                           seed=seed))
        if kills or scale_ups:
            cs.run(reqs, kills=kills, scale_ups=scale_ups)
            out = m.sim.summarize(reqs, w_p=4.0).row()
        else:
            out = row(m.sim.replay_sim(cs, reqs, w_p=4.0))
        return signature(reqs), out, cluster_counters(cs)
    return run


def scale_trace(n, rate, seed=7, until=None, kills=None, **kw):
    def run(m):
        cs = cluster(m, **kw)
        reqs = pinned(list(m.workloads.iter_scale_trace(n, rate=rate,
                                                        seed=seed)))
        if until is not None or kills:
            cs.run(reqs, until=until, kills=kills)
            out = m.sim.summarize(reqs, w_p=4.0).row()
        else:
            out = row(m.sim.replay_sim(cs, reqs, w_p=4.0))
        return signature(reqs), out, cluster_counters(cs)
    return run


def vector_policy(**policy_kw):
    def factory(m):
        return lambda: m.slide.SlideBatching(**policy_kw)
    return factory


def vector(n, rate, seed, policy_kw=None, **kw):
    def run(m):
        return scale_trace(n, rate, seed, cls="VectorClusterSim",
                           policy=vector_policy(**(policy_kw or {}))(m),
                           **kw)(m)
    return run


def stream(cls):
    def run(m):
        cs = cluster(m, cls=cls)
        rep = m.sim.replay_sim_stream(
            cs, pinned(list(m.workloads.iter_scale_trace(300, rate=600.0,
                                                         seed=13))),
            w_p=4.0, release=False)
        return row(rep), cluster_counters(cs)
    return run


def sharded(workers=0):
    def run(m):
        ex, est = exec_est(m)

        def factory():
            return m.sim.WindowedClusterSim(
                lambda: m.slide.SlideBatching(),
                m.core.GoRouting(est, m.core.RouterConfig(pd_mode="coloc")),
                ex, est, m.core.EngineConfig(w_p=4.0),
                m.sim.ClusterConfig(pd_mode="coloc", n_prefill=4))

        reqs = pinned(list(m.workloads.iter_scale_trace(600, rate=300.0,
                                                        seed=7)))
        rep, extras = m.sim.replay_sim_sharded(
            factory, reqs, workers=workers, window=0.5, w_p=4.0,
            collect=True)
        sig = sorted((r.rid, tuple(r.out_times), r.finish_time,
                      r.preemptions) for r in extras["finished"])
        return (sig, row(rep), extras["counters"], extras["windows"],
                rep.n_completed, rep.n_rejected)
    return run


SCENARIOS = {
    **{f"engine_sim_{p}": engine_sim(p) for p in (
        "slidebatching", "sarathi_fcfs", "vllm_fcfs", "fair_batching",
        "sarathi_priority")},
    "cluster_coloc": sharegpt_cluster(3, n_prefill=2),
    "cluster_disagg": sharegpt_cluster(3, pd_mode="disagg", n_prefill=2,
                                       n_decode=2),
    "cluster_disagg_heterogeneous": sharegpt_cluster(
        9, pd_mode="disagg", n_prefill=2, n_decode=2, prefill_blocks=2048,
        decode_blocks=16384, handoff_block_bytes=4096),
    "cluster_kill": sharegpt_cluster(4, router="min_load", n_prefill=3,
                                     kills=[(1.0, 0)]),
    "cluster_scale_up": sharegpt_cluster(6, rate=60, router="min_load",
                                         n_prefill=1,
                                         scale_ups=[0.5, 0.5, 0.5]),
    "cluster_tiered_host": scale_trace(300, 900.0, seed=5, n_prefill=2,
                                       host_tier_blocks=64),
    "vector_coloc_cache": vector(400, 600.0, 7),
    "vector_coloc_no_cache": vector(400, 600.0, 7, prefix_cache=False),
    "vector_disagg": vector(400, 600.0, 7, pd_mode="disagg", n_prefill=1,
                            n_decode=1),
    "vector_overload": vector(300, 1200.0, 3, n_prefill=1),
    "vector_no_density": vector(250, 700.0, 11,
                                policy_kw={"use_density": False}),
    "vector_kill": vector(200, 500.0, 5, kills=[(0.4, 0)], n_prefill=3),
    "vector_stream": stream("VectorClusterSim"),
    "windowed_load": scale_trace(400, 600.0, cls="WindowedClusterSim"),
    "windowed_overload": scale_trace(300, 2000.0, cls="WindowedClusterSim"),
    "windowed_spec": scale_trace(300, 600.0, cls="WindowedClusterSim",
                                 spec_k=2),
    "windowed_until": scale_trace(400, 600.0, cls="WindowedClusterSim",
                                  until=2.0),
    "windowed_stream": stream("WindowedClusterSim"),
    "sharded_in_process": sharded(workers=0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_sim_equals_reference(name):
    ref = SCENARIOS[name](REF)
    port = SCENARIOS[name](PORT)
    assert port == ref


def test_estimator_fit_equals_reference():
    (ex_r, est_r), (ex_p, est_p) = exec_est(REF), exec_est(PORT)
    assert vars(est_p) == vars(est_r)


# ---------------------------------------------------------------------------
# tests/test_system.py's scenarios on the port's simulator
# ---------------------------------------------------------------------------

def system_run(policy, router_name, rate=90, dur=10, seed=11):
    m = PORT
    ex, est = exec_est(m)
    reqs = m.workloads.industrial(rate=rate, duration=dur, seed=seed)
    router = (m.core.GoRouting(est, m.core.RouterConfig(pd_mode="coloc"))
              if router_name == "gorouting" else m.core.MinLoad(est))
    cs = m.sim.ClusterSim(lambda: m.core.make_policy(policy), router, ex,
                          est, m.core.EngineConfig(w_p=4.0),
                          m.sim.ClusterConfig(n_prefill=2))
    cs.run(reqs)
    return m.sim.summarize(reqs, w_p=4.0)


def test_system_proserve_beats_fcfs_baselines_under_load():
    ours = system_run("slidebatching", "gorouting")
    vllm = system_run("vllm_fcfs", "min_load")
    sarathi = system_run("sarathi_fcfs", "min_load")
    assert ours.tdg_ratio >= vllm.tdg_ratio - 0.02
    assert ours.tdg_ratio >= sarathi.tdg_ratio - 0.02


def test_system_priority_ordering_preserved():
    s = system_run("slidebatching", "gorouting", rate=110)
    assert 1 in s.per_priority and 3 in s.per_priority
    assert s.per_priority[1]["tdg_ratio"] >= \
        s.per_priority[3]["tdg_ratio"] - 0.05


# ---------------------------------------------------------------------------
# the executor: default hardware bit for bit, the H100 object
# ---------------------------------------------------------------------------

def items_sets():
    rng = np.random.default_rng(0)
    out = [[], [(1, 100, False)], [(512, 0, True), (1, 4096, False)]]
    for n in (5, 31, 32, 100):
        out.append([(int(rng.integers(1, 600)), int(rng.integers(0, 9000)),
                     bool(rng.integers(0, 2))) for _ in range(n)])
    return out


def model_profile(m, model):
    if model == "FP32":      # the reference prices fp32 weights at bf16 peak
        return m.sim.ModelProfile(*dataclasses.astuple(
            PORT.sim.QWEN1_5_0_5B_FP32))
    return getattr(m.sim, model)


@pytest.mark.parametrize("model", ["QWEN2_7B", "QWEN3_32B", "FP32"])
@pytest.mark.parametrize("chips", [1, 4])
def test_default_hardware_matches_reference_bitwise(model, chips):
    exs = [m.sim.AnalyticalExecutor(model_profile(m, model),
                                    m.sim.InstanceHardware(chips=chips))
           for m in (REF, PORT)]
    r, p = exs
    assert (p.num_blocks, p.t_block) == (r.num_blocks, r.t_block)
    assert p.hw.flops_per_s == r.hw.flops_per_s
    assert p.hw.bytes_per_s == r.hw.bytes_per_s
    for items in items_sets():
        assert p.batch_latency(items) == r.batch_latency(items)
    b_r, l_r = r.profile_batches(np.random.default_rng(3), n=60)
    b_p, l_p = p.profile_batches(np.random.default_rng(3), n=60)
    assert (b_p, l_p) == (b_r, l_r)
    est_r, mape_r = r.fit_estimator(seed=2, n=80)
    est_p, mape_p = p.fit_estimator(seed=2, n=80)
    assert mape_p == mape_r
    assert vars(est_p) == vars(est_r)


def test_module_constants_equal_reference():
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_BYTES",
                 "HOST_LINK_BW"):
        assert getattr(PORT.sim, name) == getattr(REF.sim, name)
    ref_hw = REF.sim.InstanceHardware()
    port_hw = PORT.sim.InstanceHardware()
    for f in dataclasses.fields(ref_hw):
        assert getattr(port_hw, f.name) == getattr(ref_hw, f.name)
    assert (port_hw.peak_flops, port_hw.hbm_bw, port_hw.hbm_bytes,
            port_hw.host_link_bw) == (REF.sim.PEAK_FLOPS, REF.sim.HBM_BW,
                                      REF.sim.HBM_BYTES,
                                      REF.sim.HOST_LINK_BW)


CHIP_FIELDS = {"peak_flops", "peak_flops_fp32", "hbm_bw", "hbm_bytes",
               "host_link_bw"}


@pytest.mark.parametrize("chips", [1, 4])
def test_h100_changes_only_the_constants_it_names(chips):
    base = PORT.sim.InstanceHardware(chips=chips)
    h100 = PORT.sim.InstanceHardware.h100(chips=chips)
    changed = {f.name for f in dataclasses.fields(base)
               if getattr(base, f.name) != getattr(h100, f.name)}
    assert changed == CHIP_FIELDS
    chip = PORT.sim.H100_SXM
    assert (h100.peak_flops, h100.peak_flops_fp32, h100.hbm_bw,
            h100.hbm_bytes) == (989e12, 67e12, 3.35e12, 80e9)
    assert h100.host_link_bw == chip.host_link_bw
    assert 20e9 < chip.host_link_bw < 64e9       # a PCIe gen5 x16 link
    # mfu / hbm_eff / t_launch keep the reference's assumed values
    assert (h100.mfu, h100.hbm_eff, h100.t_launch) == (0.5, 0.8, 3e-3)
    # a measured step floor replaces t_launch and nothing else
    tuned = PORT.sim.InstanceHardware.h100(chips=chips, t_launch=0.0123)
    assert {f.name for f in dataclasses.fields(h100)
            if getattr(h100, f.name) != getattr(tuned, f.name)} \
        == {"t_launch"}


@pytest.mark.parametrize("dtype_bytes,peak", [(2, 989e12), (4, 67e12)])
def test_h100_prices_compute_at_the_weights_dtype_peak(dtype_bytes, peak):
    prof = dataclasses.replace(PORT.sim.QWEN1_5_0_5B_FP32,
                               dtype_bytes=dtype_bytes)
    hw = PORT.sim.InstanceHardware.h100(t_launch=0.0)
    ex = PORT.sim.AnalyticalExecutor(prof, hw)
    items = [(4096, 0, True)] * 4                 # compute-bound prefill
    flops = sum(2.0 * prof.n_active * q
                + 4.0 * prof.n_layers * prof.d_model * q * (k + q / 2.0)
                for q, k, _ in items)
    assert hw.flops_per_s_for(dtype_bytes) == peak * hw.mfu
    assert ex.batch_latency(items) == pytest.approx(flops / (peak * hw.mfu),
                                                    rel=1e-12)


def test_h100_executor_prices_with_its_constants():
    m = PORT.sim
    prof = m.QWEN1_5_0_5B_FP32
    hw = m.InstanceHardware.h100()
    ex = m.AnalyticalExecutor(prof, hw)
    block = prof.kv_bytes_per_token * 16
    assert block == 3 * 2**20           # one fp32 KV block of the port
    assert ex.num_blocks == int(0.35 * 80e9 // block)
    assert ex.t_block == block / m.H100_SXM.host_link_bw
    items = [(512, 0, True), (1, 700, False), (1, 33, False)]
    flops = sum(2.0 * prof.n_active * q
                + 4.0 * prof.n_layers * prof.d_model * q * (k + q / 2.0)
                for q, k, _ in items)
    new = sum(q for q, _, _ in items)
    mem = (prof.n_params * 4 + sum((k + q) for q, k, _ in items)
           * prof.kv_bytes_per_token + new * prof.kv_bytes_per_token)
    # fp32 weights: the card's fp32 peak, not its bf16 tensor-core peak
    want = max(flops / (67e12 * 0.5), mem / (3.35e12 * 0.8)) + 3e-3
    assert math.isclose(ex.batch_latency(items), want, rel_tol=1e-12)


def test_qwen_profile_is_the_config_the_port_serves():
    from repro_torch.configs import get
    cfg = get("qwen1_5_0_5b")
    prof = PORT.sim.QWEN1_5_0_5B_FP32
    assert prof.n_params == prof.n_active == cfg.param_count()
    assert (prof.n_layers, prof.d_model, prof.n_kv_heads, prof.head_dim,
            prof.dtype_bytes) == (cfg.n_layers, cfg.d_model, cfg.n_kv_heads,
                                  cfg.hd, 4)


# ---------------------------------------------------------------------------
# entry points: the launcher's --mode sim and the replay CLI
# ---------------------------------------------------------------------------

def test_launcher_sim_cell_equals_reference():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.common import run_multi_node as ref_cell
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.launch.multi_node import run_multi_node
    kw = dict(pd_mode="coloc", n_prefill=2, duration=3.0, seed=1)
    want, _ = ref_cell("industrial", 30.0, "slidebatching", "gorouting",
                       **kw)
    got, _ = run_multi_node("industrial", 30.0, "slidebatching",
                            "gorouting", **kw)
    assert got == want


def test_serve_mode_sim_prints_the_cell(capsys):
    from repro_torch.launch import serve
    from repro_torch.launch.multi_node import run_multi_node
    out = serve.main(["--mode", "sim", "--dataset", "sharegpt", "--rate",
                      "10", "--duration", "2", "--instances", "2",
                      "--hardware", "h100", "--model", "qwen1.5-0.5b"])
    want, reqs = run_multi_node("sharegpt", 10.0, "slidebatching",
                                "gorouting", n_prefill=2, duration=2.0,
                                hardware="h100", model="qwen1.5-0.5b")
    assert out == want
    assert all(r.finish_time is not None for r in reqs)
    assert '"tdg_ratio"' in capsys.readouterr().out


def test_replay_cli_sim_mode_equals_reference(capsys):
    from repro.sim import replay as ref_replay
    from repro_torch.sim import replay as port_replay
    argv = ["--workload", "sharegpt", "--mode", "sim", "--rate", "10",
            "--duration", "2", "--vector"]
    outs = []
    for mod in (ref_replay, port_replay):
        mod._main(argv)
        text = capsys.readouterr().out
        outs.append({k: v for k, v in
                     __import__("json").loads(text).items()
                     if k != "wall_s"})
    assert outs[0] == outs[1]


def test_sharded_replay_forked_workers_equal_in_process():
    """``tests/test_shard_merge.py``'s partition check on the port's
    shard module: forked workers and the in-process twin give identical
    per-request results, summaries and engine counters.  In a fresh
    interpreter that imports only ``repro_torch.sim`` (forking a process
    that carries JAX's thread pool can deadlock)."""
    import os
    import subprocess
    script = _WORKERS_SCRIPT
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ROOT / "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("IDENTICAL"), res.stdout


_WORKERS_SCRIPT = """
import sys
from repro_torch.core import EngineConfig, GoRouting, RouterConfig
from repro_torch.core.slidebatching import SlideBatching
from repro_torch.sim import (AnalyticalExecutor, ClusterConfig,
                             InstanceHardware, QWEN2_7B, WindowedClusterSim,
                             iter_scale_trace, replay_sim_sharded)

ex = AnalyticalExecutor(QWEN2_7B, InstanceHardware(chips=4))
est, _ = ex.fit_estimator(n=200)


def factory():
    return WindowedClusterSim(
        lambda: SlideBatching(),
        GoRouting(est, RouterConfig(pd_mode="coloc")),
        ex, est, EngineConfig(w_p=4.0),
        ClusterConfig(pd_mode="coloc", n_prefill=4))


def trace():
    reqs = list(iter_scale_trace(600, rate=300.0, seed=7))
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


results = {}
for w in (0, 2):
    rep, extras = replay_sim_sharded(factory, trace(), workers=w,
                                     window=0.5, w_p=4.0, collect=True)
    sig = sorted((r.rid, tuple(r.out_times), r.finish_time,
                  r.preemptions) for r in extras["finished"])
    results[w] = (sig, rep.summary, extras["counters"],
                  rep.n_completed, rep.n_rejected)
assert results[0] == results[2], "sharded replay diverged across workers"
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "the port's sim imported jax or repro"
print("IDENTICAL", results[2][3], results[2][4])
"""
