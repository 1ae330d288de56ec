"""The port's dry run (``repro_torch.launch.dryrun``) and its per-rank
counts, held against the reference's ``hlo_cost.analyze`` and
``memory_analysis`` on the same SMOKE steps.

* One rank: the reference compiles its steps in this process on a
  directly built one-device ``jax.sharding.Mesh`` (``make_debug_mesh``'s
  Explicit axes refuse its sharding constraints: ROADMAP Queue 3 item
  7); the port traces its steps on a one-rank ``fake`` group.  Flops and
  argument bytes are equal, exactly.
* (4, 2): the reference on 8 host devices, the port on a ``fake`` group
  of 8, both in ``tests/_torch_cost_worker.py`` processes.  The argument
  bytes are equal; the flops and collectives differ, and the difference
  is attributed and pinned (ROADMAP Queue 3 item 12).
* ``run_cell`` on (4, 2) for every family and a train cell, and on the
  production meshes of 256 and 512 ranks.

Every worker job runs side by side in the module fixture, each with a
time limit of its own.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun, hlo_cost

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_cost_worker.py"
LIMIT_S = 240                   # each job's own time limit
JOBS = ("port1", "port42", "ref42", "cells", "train_cell", "production")
STEPS = ("qwen1_5_0_5b/serve", "qwen1_5_0_5b/prefill", "qwen1_5_0_5b/train",
         "olmoe_1b_7b/serve")
# the reference's per-device flops of those steps (hlo_cost.analyze)
ONE_RANK_FLOPS = {"qwen1_5_0_5b/serve": 2_097_152,
                  "qwen1_5_0_5b/prefill": 436_469_760,
                  "qwen1_5_0_5b/train": 1_811_939_328,
                  "olmoe_1b_7b/serve": 2_899_968}
RECORD_KEYS = {"arch", "shape", "mesh", "variant", "ok", "skipped", "chips",
               "trace_s", "meta", "nodes", "memory", "flops_per_device",
               "bytes_per_device", "collectives", "roofline",
               "model_flops_total", "useful_flops_ratio"}
MEMORY_KEYS = {"argument", "output", "alias", "temp", "peak",
               "per_device_total", "fits_80GB", "utilization"}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    base = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
            "HOME": str(root)}
    jax_env = {**base, "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS",
                                                       "cpu"),
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    t0 = time.monotonic()
    procs = {job: subprocess.Popen(
        [sys.executable, str(WORKER), job, str(root / f"{job}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=jax_env if job == "ref42" else base, cwd=ROOT) for job in JOBS}
    out = {}
    for job, p in procs.items():
        left = max(1.0, LIMIT_S - (time.monotonic() - t0))
        try:
            log, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"job {job} passed its {LIMIT_S} s limit")
        assert p.returncode == 0, f"{job}:\n{log.decode()[-4000:]}"
        out[job] = json.loads((root / f"{job}.json").read_text())
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def ref1():
    """The reference's SMOKE steps on one device: (flops, argument
    bytes) by step."""
    from jax.sharding import Mesh

    from repro.configs import get_smoke
    from repro.distributed.sharding import ShardingPolicy
    from repro.launch import hlo_cost as ref_cost
    from repro.launch import steps

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_cost_worker import PREFILL, SERVE, TRAIN

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    sds = jax.ShapeDtypeStruct
    out = {}
    for name in STEPS:
        arch, kind = name.split("/")
        cfg = get_smoke(arch)
        pol = ShardingPolicy(mesh=mesh, mode="train" if kind == "train"
                             else "serve")
        with mesh:
            if kind == "train":
                jitted, st, _ = steps.build_train_step(cfg, pol,
                                                       microbatches=1)
                batch = {k: sds((TRAIN[3], TRAIN[2]), jnp.int32)
                         for k in ("tokens", "labels")}
                lowered = jitted.lower(st[0], st[1], batch)
            elif kind == "prefill":
                jitted, st, _ = steps.build_prefill_step(cfg, pol)
                lowered = jitted.lower(
                    st[0], sds((PREFILL[3], PREFILL[2]), jnp.int32))
            else:
                jitted, st, _ = steps.build_serve_step(cfg, pol)
                lowered = jitted.lower(
                    st[0], steps.cache_struct(cfg, SERVE[3], SERVE[2]),
                    sds((SERVE[3],), jnp.int32))
            compiled = lowered.compile()
        out[name] = (ref_cost.analyze(compiled.as_text())["flops"],
                     compiled.memory_analysis().argument_size_in_bytes)
    return out


# --------------------------------------------------------------------------
# one rank: exact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", STEPS)
def test_one_rank_flops_equal_the_reference(jobs, ref1, name):
    assert jobs["port1"][name]["flops"] == ref1[name][0] \
        == ONE_RANK_FLOPS[name]


@pytest.mark.parametrize("name", STEPS)
def test_one_rank_argument_bytes_equal_the_reference(jobs, ref1, name):
    assert jobs["port1"][name]["memory"]["argument"] == ref1[name][1]


def test_one_rank_moves_no_collective(jobs):
    for name in STEPS:
        assert jobs["port1"][name]["collectives"]["total"] == 0


# --------------------------------------------------------------------------
# (4, 2): argument bytes equal, flops and collectives attributed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,argument", [("qwen1_5_0_5b", 181_264),
                                           ("olmoe_1b_7b", 232_208)])
def test_4x2_argument_bytes_equal_the_reference(jobs, arch, argument):
    assert jobs["port42"][arch]["memory"]["argument"] \
        == jobs["ref42"][arch]["argument"] == argument


def test_4x2_dense_decode_flops_differ_by_the_first_layer_mlp(jobs):
    """Layer 0's residual enters its MLP as Partial(sum) over "model" (the
    row-parallel ``wo`` leaves it so, and DTensor keeps it through the
    residual add and RMSNorm's scale), so DTensor gathers ``w_gate`` /
    ``w_up`` whole and runs them on the full d_ff: twice the reference's
    flops for those two matmuls.  Layer 1's MLP is the reference's."""
    port, ref = jobs["port42"]["qwen1_5_0_5b"], jobs["ref42"]["qwen1_5_0_5b"]
    mlp0, mlp1 = port["spans"]["mlp"]
    rows, d, ff_local = 2, 64, 64         # (8 rows / 4, d_model, d_ff / 2)
    assert mlp1 == 3 * 2 * rows * d * ff_local == 49_152
    assert mlp0 == 2 * (2 * rows * d * 2 * ff_local) + mlp1 // 3 == 81_920
    assert port["flops"] == 294_912 and ref["flops"] == 262_144
    assert port["flops"] - ref["flops"] == mlp0 - mlp1 == 32_768


def test_4x2_moe_decode_flops_differ_by_the_second_layer_router(jobs):
    """Layer 0 leaves the residual split over both axes (batch over
    "data" x "model"), so layer 1's replicated router runs on one of each
    rank's two rows: fewer flops than the reference, which keeps every
    layer's residual P(dp, None, None)."""
    port, ref = jobs["port42"]["olmoe_1b_7b"], jobs["ref42"]["olmoe_1b_7b"]
    router0, router1 = port["spans"]["router"]
    assert router0 == 2 * 2 * 64 * 8 and router1 == router0 // 2
    assert port["flops"] == 363_520 and ref["flops"] == 364_544
    assert port["flops"] - ref["flops"] == router1 - router0 == -1024


def test_4x2_decode_collectives_are_pinned(jobs):
    """The reference all-reduces after each row-parallel matmul; DTensor
    keeps a Partial(sum) and reduce-scatters it onto the batch when an op
    needs the sum.  The port also gathers the embedding table whole for
    the lookup (Queue 3 item 10) and, in layer 0, the dense MLP's three
    weights."""
    port = jobs["port42"]["qwen1_5_0_5b"]
    ref = jobs["ref42"]["qwen1_5_0_5b"]
    assert port["collectives"]["counts"] == {
        "all-gather": 16, "all-reduce": 6, "reduce-scatter": 7,
        "all-to-all": 0, "collective-permute": 0}
    assert ref["collectives"]["counts"] == {
        "all-gather": 12, "all-reduce": 9, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    gathers = port["gathers"]
    assert gathers.count([256, 64]) == 1            # the embedding table
    assert gathers.count([128, 64]) == 3            # layer 0's MLP weights
    moe_port = jobs["port42"]["olmoe_1b_7b"]["collectives"]["counts"]
    moe_ref = jobs["ref42"]["olmoe_1b_7b"]["collectives"]["counts"]
    assert (moe_port["all-gather"], moe_port["all-reduce"],
            moe_port["reduce-scatter"]) == (22, 7, 5)
    assert (moe_ref["all-gather"], moe_ref["all-reduce"],
            moe_ref["reduce-scatter"]) == (14, 9, 0)


# --------------------------------------------------------------------------
# run_cell, _save, parse_variant, the skip rule, the torch gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid",
                                    "encdec"])
def test_run_cell_prices_a_serve_cell_of_each_family(jobs, family):
    rec = jobs["cells"][family]
    assert rec["ok"] and not rec["skipped"], rec.get("error")
    assert set(rec) == RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert rec["chips"] == 8 and rec["flops_per_device"] > 0
    assert rec["memory"]["fits_80GB"]
    assert rec["memory"]["alias"] > 0             # the cache, in place
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops_per_device"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == rec["bytes_per_device"] / dryrun.HBM_BW
    assert r["collective_s"] == \
        rec["collectives"]["total"] / dryrun.LINK_BW
    assert r["dominant"] == max(("compute", "memory", "collective"),
                                key=lambda k: r[f"{k}_s"])


def test_run_cell_prices_a_train_cell_with_its_loop_weighted(jobs):
    rec = jobs["train_cell"]
    assert rec["ok"], rec.get("error")
    assert set(rec) == RECORD_KEYS
    assert rec["meta"] == {"microbatches": 2, "loop_traced_once": True}
    # 6ND over the 16 x 32 tokens of the cell
    assert rec["model_flops_total"] > 0 and rec["useful_flops_ratio"] > 0
    saved = jobs["root"] / "train_cell"
    assert (saved / "qwen1_5_0_5b__train_16x32__single__mb2.json").exists()


@pytest.mark.parametrize("mesh,chips", [("single", 256), ("multi", 512)])
def test_a_smoke_cell_runs_on_each_production_mesh(jobs, mesh, chips):
    rec = jobs["production"][mesh]
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == chips
    assert rec["collectives"]["total"] > 0


def test_saved_file_names_are_the_references(jobs, tmp_path):
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_cost_worker import SAVED

    for rec in SAVED:
        dryrun._save(dict(rec), str(tmp_path))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == jobs["ref42"]["saved"]
    # the traceback stays out of the file
    assert "trace" not in json.loads(
        (tmp_path / "olmoe_1b_7b__decode_32k__single__fsdp0.json")
        .read_text())


def test_parse_variant_is_the_references():
    from repro.launch.steps import parse_variant as ref_parse
    from repro_torch.launch.steps import parse_variant

    for text in ("", "mb=8,attn=dense,grad_rs=1,fsdp=0",
                 "microbatches=2,attn_impl=chunked,compress=1,sp=0,"
                 "seqkv=0"):
        assert parse_variant(text) == ref_parse(text)
    for parse in (parse_variant, ref_parse):
        with pytest.raises(ValueError, match="unknown variant key"):
            parse("nope=1")


def test_the_skip_rule_is_the_references(tmp_path):
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import get as ref_get
    from repro.launch.steps import cell_supported as ref_supported
    from repro_torch.configs import ARCH_IDS, get
    from repro_torch.launch.steps import SHAPES, cell_supported

    assert list(ARCH_IDS) == list(REF_IDS)
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert cell_supported(get(arch), shape) == \
                ref_supported(ref_get(arch), shape)
    rec = dryrun.run_cell("qwen1_5_0_5b", "long_500k", False, str(tmp_path),
                          verbose=False)
    assert rec["ok"] and rec["skipped"] and "sub-quadratic" in rec["reason"]
    assert (tmp_path / "qwen1_5_0_5b__long_500k__single.json").exists()
    assert cell_supported(get("mamba2_1_3b"), "long_500k")[0]


def test_an_older_torch_refuses_a_multi_rank_axis(monkeypatch):
    class FakeMesh:
        def __init__(self, **axes):
            self.shape, self.axis_names = axes, tuple(axes)

    monkeypatch.setattr(torch, "__version__", "2.11.0+cu128")
    with pytest.raises(RuntimeError, match="Queue 3 item 11"):
        dryrun.check_torch(FakeMesh(data=16, model=16))
    dryrun.check_torch(FakeMesh(data=1, model=1))
    monkeypatch.setattr(torch, "__version__", "2.13.0+cpu")
    dryrun.check_torch(FakeMesh(data=16, model=16))


def test_price_uses_the_h100_datasheet_peaks():
    from repro_torch.sim.executor import H100_SXM

    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.HBM_BYTES) == \
        (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.hbm_bytes) \
        == (989e12, 3.35e12, 80e9)
    assert dryrun.LINK_BW == 50e9
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import ShapeSpec

    graph = hlo_cost.trace(lambda a, b: a @ b,
                           torch.empty(64, 96, device="meta"),
                           torch.empty(96, 32, device="meta"))
    cfg = get_smoke("qwen1_5_0_5b")
    rec = dryrun.price(graph, cfg, ShapeSpec("p", "prefill", 16, 2), 1)
    assert rec["flops_per_device"] == 2 * 64 * 96 * 32
    assert rec["memory"]["per_device_total"] == \
        (64 * 96 + 96 * 32 + 64 * 32) * 4
    assert rec["model_flops_total"] == 2.0 * cfg.active_param_count() * 32


def test_main_runs_the_named_cells(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1_5_0_5b", "--shape", "long_500k", "--mesh", "both",
         "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dry-run complete: 2 ok, 0 failed" in proc.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen1_5_0_5b__long_500k__multi.json",
        "qwen1_5_0_5b__long_500k__single.json"]
