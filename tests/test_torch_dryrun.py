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
  bytes and the flops are equal; the collectives differ, and the
  difference is attributed and pinned (ROADMAP Queue 3 item 12).
* (2, 2, 2), the production mesh's three axes ("pod", "data", "model"):
  the same on the SMOKE qwen and olmoe serve, prefill and train steps.
  The argument bytes are equal; the flops are equal but for the MoE
  router's, and the collectives differ; both are attributed and pinned
  (ROADMAP Queue 3 item 12).
* ``run_cell`` on (4, 2) for every family and a train cell, and on the
  production meshes of 256 and 512 ranks, where no redistribution takes
  DTensor's graph-based planner.
* The cross-entropy on logits split over the vocabulary: no all-gather
  of the vocabulary.

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
JOBS = ("port1", "port42", "ref42", "port222", "ref222", "cells",
        "train_cell", "production", "loss")
# the reference's jobs, on 8 host devices
REF_JOBS = ("ref42", "ref222")
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
        env=jax_env if job in REF_JOBS else base, cwd=ROOT) for job in JOBS}
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
# (4, 2): argument bytes and flops equal, collectives attributed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,argument", [("qwen1_5_0_5b", 181_264),
                                           ("olmoe_1b_7b", 232_208)])
def test_4x2_argument_bytes_equal_the_reference(jobs, arch, argument):
    assert jobs["port42"][arch]["memory"]["argument"] \
        == jobs["ref42"][arch]["argument"] == argument


def test_4x2_dense_decode_flops_differ_by_the_first_layer_mlp(jobs):
    """They no longer differ.  Each projection's input is brought to its
    batch placement alone (``models.layers.batch_only``) and each decode
    residual sum is reduced once, where the reference all-reduces a
    row-parallel output: layer 0's MLP runs on its own d_ff shard, as
    layer 1's does, and the flops are the reference's."""
    port, ref = jobs["port42"]["qwen1_5_0_5b"], jobs["ref42"]["qwen1_5_0_5b"]
    mlp0, mlp1 = port["spans"]["mlp"]
    rows, d, ff_local = 2, 64, 64         # (8 rows / 4, d_model, d_ff / 2)
    assert mlp0 == mlp1 == 3 * 2 * rows * d * ff_local == 49_152
    assert port["flops"] == ref["flops"] == 262_144


def test_4x2_moe_decode_flops_differ_by_the_second_layer_router(jobs):
    """They no longer differ: every layer's residual keeps the batch over
    "data" alone, as the reference's P(dp, None, None), so both routers
    work on each rank's two rows."""
    port, ref = jobs["port42"]["olmoe_1b_7b"], jobs["ref42"]["olmoe_1b_7b"]
    router0, router1 = port["spans"]["router"]
    assert router0 == router1 == 2 * 2 * 64 * 8
    assert port["flops"] == ref["flops"] == 364_544


def test_4x2_decode_collectives_are_pinned(jobs):
    """The port gathers the embedding table whole for the lookup (Queue 3
    item 10) and, in each layer, q / k / v over the heads: the decode
    core runs every head on its own cache positions, and the new
    position's k / v are written into a sequence-split cache.  Each
    layer all-reduces three softmax parts of that core (the max, the
    sum, the output) and two row-parallel outputs (``wo``, ``w_down``).
    The MoE steps also gather the experts' outputs over "model" for the
    combine, which each rank runs on its own rows."""
    port = jobs["port42"]["qwen1_5_0_5b"]
    ref = jobs["ref42"]["qwen1_5_0_5b"]
    assert port["collectives"]["counts"] == {
        "all-gather": 7, "all-reduce": 10, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    assert ref["collectives"]["counts"] == {
        "all-gather": 12, "all-reduce": 9, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    gathers = port["gathers"]
    assert gathers.count([256, 64]) == 1            # the embedding table
    assert gathers.count([4, 1, 2, 16]) == 6        # q, k, v a layer
    moe_port = jobs["port42"]["olmoe_1b_7b"]["collectives"]["counts"]
    moe_ref = jobs["ref42"]["olmoe_1b_7b"]["collectives"]["counts"]
    assert (moe_port["all-gather"], moe_port["all-reduce"],
            moe_port["reduce-scatter"]) == (9, 8, 0)
    assert (moe_ref["all-gather"], moe_ref["all-reduce"],
            moe_ref["reduce-scatter"]) == (14, 9, 0)


# --------------------------------------------------------------------------
# (2, 2, 2): argument bytes equal, flops and collectives attributed
# --------------------------------------------------------------------------

STEPS_222 = {"qwen1_5_0_5b/serve": 181_264, "qwen1_5_0_5b/prefill": 116_736,
             "qwen1_5_0_5b/train": 410_628, "olmoe_1b_7b/serve": 232_208,
             "olmoe_1b_7b/prefill": 167_680, "olmoe_1b_7b/train": 939_268}


@pytest.mark.parametrize("name,argument", STEPS_222.items())
def test_2x2x2_argument_bytes_equal_the_reference(jobs, name, argument):
    """The batch over ("pod", "data"), FSDP over "data" alone and
    replicated over "pod", TP over "model": each rank holds the bytes the
    reference's partitioner gives it."""
    assert jobs["port222"][name]["memory"]["argument"] \
        == jobs["ref222"][name]["argument"] == argument


@pytest.mark.parametrize("name", STEPS_222)
def test_2x2x2_flops_equal_the_reference_but_the_moe_router(jobs, name):
    """Equal, but for the MoE router in prefill and train: the port runs
    routing, dispatch and combine on each rank's batch rows whole
    (``models.layers.on_batch_shards``), so every "model" rank computes
    the router's logits over all of its rows' tokens; the reference's
    partitioner computes them on the sequence shard that the residual
    stream holds there, 1 / 2 of the tokens.  The difference is the
    other half of the router's matmul: 2 x tokens x d x E a layer, once
    in prefill, 4 times in train (forward, the remat forward, and two
    products in the backward)."""
    from repro_torch.configs import get_smoke

    arch, kind = name.split("/")
    port, ref = jobs["port222"][name]["flops"], jobs["ref222"][name]["flops"]
    cfg = get_smoke(arch)
    tokens = 8 // 4 * 128                 # a rank's batch rows x seq
    router = 2 * tokens * cfg.d_model * cfg.n_experts * cfg.n_layers
    extra = {"serve": 0, "prefill": router // 2, "train": 4 * router // 2}
    assert port - ref == (extra[kind] if cfg.family == "moe" else 0)
    if cfg.family == "moe" and kind != "serve":
        assert port - ref == {"prefill": 262_144, "train": 1_048_576}[kind]


def _counts(ag, ar, rs, a2a, cp):
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": rs,
            "all-to-all": a2a, "collective-permute": cp}


# (port, reference) collectives by kind; attributed in ROADMAP Queue 3
# item 12
COLLECTIVES_222 = {
    "qwen1_5_0_5b/serve": (_counts(7, 10, 0, 0, 0), _counts(12, 9, 0, 0, 0)),
    "qwen1_5_0_5b/prefill": (_counts(8, 0, 4, 4, 0),
                             _counts(25, 1, 0, 0, 7)),
    "qwen1_5_0_5b/train": (_counts(81, 190, 48, 0, 0),
                           _counts(85, 26, 0, 0, 12)),
    "olmoe_1b_7b/serve": (_counts(9, 8, 0, 0, 0), _counts(14, 9, 0, 0, 0)),
    "olmoe_1b_7b/prefill": (_counts(10, 0, 2, 4, 0),
                            _counts(25, 3, 0, 0, 7)),
    "olmoe_1b_7b/train": (_counts(71, 209, 38, 0, 0),
                          _counts(75, 30, 0, 0, 12)),
}


@pytest.mark.parametrize("name", STEPS_222)
def test_2x2x2_collectives_are_pinned(jobs, name):
    """The decode steps move what they move on (4, 2): "pod" and "data"
    together split the batch as "data" alone did.  Prefill: the port
    all-gathers the sequence before each projection (Megatron's
    all-gather, ``models.layers.batch_only``) and reduce-scatters each
    row-parallel output back onto it, and moves the attention's query
    rows by all-to-all; the reference's partitioner gathers more operands
    and shifts others by collective-permute.  Train: DTensor reduces a
    sum over the batch shards with one collective per mesh dim ("pod"
    and "data" apart, where XLA runs one over both) and one per
    gradient leaf and op, where XLA's combiner merges them: most of the
    port's all-reduces are those."""
    port, ref = COLLECTIVES_222[name]
    assert jobs["port222"][name]["collectives"]["counts"] == port
    assert jobs["ref222"][name]["collectives"]["counts"] == ref


def test_the_loss_never_gathers_the_vocabulary(jobs):
    """The cross-entropy and its gradient on SMOKE logits split over the
    vocabulary ("model", 4 ranks) and the batch ("data", 2): each rank
    reduces its own vocab shard, and the shards' parts, a few numbers a
    token, are what moves.  No all-gather's result holds a rank's rows
    of the logits over the whole vocabulary."""
    rec = jobs["loss"]
    assert rec["gathers"]
    assert max(rec["gathers"]) < rec["rows_x_vocab"] == 2 * 16 * 256


# --------------------------------------------------------------------------
# run_cell, _save, parse_variant, the skip rule
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


@pytest.mark.parametrize("cell", ["single", "multi", "multi_train"])
def test_no_redistribution_takes_the_graph_planner(jobs, cell):
    """DTensor plans a redistribution with its graph-based planner only
    for a spec with a ``_StridedShard`` or a non-default shard order, and
    that planner's cost grows with the mesh: it made a train cell's trace
    on (2, 16, 16) take 35 min.  No spec of the port's steps has either,
    so no plan is made so, on three axes as on two."""
    rec = jobs["production"][cell]
    assert rec["ok"], rec.get("error")
    assert rec["graph_plans"] == 0


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
