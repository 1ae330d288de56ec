"""Dry run of every (architecture x input shape) cell on the 16x16
single-pod mesh and the 2x16x16 multi-pod mesh, priced for the H100
(port of ``repro.launch.dryrun``): trace each step's per-rank program,
check that it fits one card's 80 GB, and extract the roofline terms
(FLOPs / bytes / collective bytes) from the traced graph
(``launch.hlo_cost``).

No card is needed, as the reference needs no TPU: the meshes live on
``fake`` process groups of 256 or 512 ranks in this one process, the
inputs are ``meta`` tensors, and nothing runs on any device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out build/dryrun

Results land as JSON under --out (default build/dryrun/), one file per
(arch, shape, mesh), named as the reference names them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch.distributed as dist

from . import hlo_cost
from ..configs import ARCH_IDS, get
from ..distributed.sharding import ShardingPolicy
from ..models.model import ArchConfig
from ..sim.executor import H100_SXM
from .mesh import make_production_mesh
from .steps import (SHAPES, Shape, _spec, build_cell, cell_supported,
                    parse_variant)

# H100 SXM constants (per card): dense bf16 (``steps.COMPUTE_DTYPE``)
# and HBM3, from the H100 SXM datasheet
PEAK_FLOPS = H100_SXM.peak_flops
HBM_BW = H100_SXM.hbm_bw
HBM_BYTES = H100_SXM.hbm_bytes
# Each GPU's link to the network: the DGX H100 datasheet gives every GPU
# one ConnectX-7 port at 400 Gb/s (NDR InfiniBand), 50e9 B/s.  NVLink 4
# joins the eight GPUs of one DGX at 900 GB/s per GPU (bidirectional; H100
# SXM datasheet), but every axis of the (16, 16) and (2, 16, 16) meshes
# spans more than one eight-GPU NVLink domain, so the network link bounds
# the collectives.  This takes the place of the reference's ``ICI_BW``.
LINK_BW = 50e9


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks in this process (rank
    0), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tokens(shape: Shape) -> int:
    sp = _spec(shape)
    if sp.kind in ("train", "prefill"):
        return sp.batch * sp.seq
    return sp.batch            # decode: one token per request


def price(graph, cfg: ArchConfig, shape: Shape, chips: int) -> dict:
    """The record's cost, memory and roofline terms of one traced
    per-rank program (``hlo_cost.trace_step``)."""
    acc = hlo_cost.analyze(graph)
    mem = hlo_cost.memory_analysis(graph)
    flops, bytes_hbm = acc["flops"], acc["bytes"]
    # the reference also subtracts a ``cpu_upcast_artifact`` (fp32 copies
    # that XLA-CPU makes of bf16 dot operands): the traced graph holds the
    # card's dtypes, so there is nothing to subtract
    per_dev = (mem["argument"] + mem["output"] + mem["temp"]
               - mem["alias"])
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_hbm / HBM_BW
    collective_s = acc["collectives"]["total"] / LINK_BW
    # 6ND for training (fwd+bwd), 2ND for inference passes
    flop_factor = 6.0 if _spec(shape).kind == "train" else 2.0
    model_flops = flop_factor * cfg.active_param_count() * _tokens(shape)
    return dict(
        memory={**mem, "per_device_total": per_dev,
                "fits_80GB": bool(per_dev <= HBM_BYTES),
                "utilization": per_dev / HBM_BYTES},
        flops_per_device=flops, bytes_per_device=bytes_hbm,
        collectives=acc["collectives"],
        roofline={"compute_s": compute_s, "memory_s": memory_s,
                  "collective_s": collective_s,
                  "dominant": max(
                      [("compute", compute_s), ("memory", memory_s),
                       ("collective", collective_s)],
                      key=lambda kv: kv[1])[0]},
        model_flops_total=model_flops,
        useful_flops_ratio=(model_flops / (flops * chips)
                            if flops else 0.0))


def trace_cell(cfg: ArchConfig, shape: Shape, mesh, variant: str = ""):
    """(graph, meta, seconds): ``shape``'s step traced on ``mesh``.  A
    train step of several microbatches is traced with its loop run once
    and weighted (``hlo_cost.one_microbatch``); ``meta`` says so."""
    var = parse_variant(variant)
    mode = "train" if _spec(shape).kind == "train" else "serve"
    policy = ShardingPolicy(mesh=mesh, mode=mode, **var["policy"])
    t0 = time.time()
    step, structs, meta = build_cell(cfg, shape, policy, device="cpu",
                                     **var["build"])
    once = meta.get("microbatches", 1) > 1
    with hlo_cost.one_microbatch() if once else contextlib.nullcontext():
        graph = hlo_cost.trace_step(step, structs)
    if once:
        meta = {**meta, "loop_traced_once": True}
    return graph, meta, time.time() - t0


def run_cell(arch: str, shape: Shape, multi_pod: bool, out_dir: str,
             verbose: bool = True, save_graph: bool = False,
             variant: str = "", *, cfg: Optional[ArchConfig] = None,
             mesh=None) -> dict:
    """One cell's record, saved under ``out_dir``.  ``cfg`` replaces
    ``get(arch)`` and ``mesh`` the production mesh (which is otherwise
    built on a ``fake`` group made and destroyed here); ``shape`` is a
    name of ``SHAPES`` or a ``ShapeSpec``."""
    cfg = cfg or get(arch)
    name = _spec(shape).name
    ok, why = cell_supported(cfg, name)
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": name, "mesh": mesh_name,
           "variant": variant, "ok": False, "skipped": False}
    if not ok:
        rec.update(skipped=True, reason=why, ok=True)
        _save(rec, out_dir)
        if verbose:
            print(f"[skip] {arch} × {name}: {why}")
        return rec
    try:
        with contextlib.ExitStack() as stack:
            if mesh is None:
                stack.enter_context(fake_world(512 if multi_pod else 256))
                cell_mesh = make_production_mesh(multi_pod=multi_pod,
                                                 device_type="cpu")
            else:
                cell_mesh = mesh
            graph, meta, t_trace = trace_cell(cfg, shape, cell_mesh,
                                              variant)
            chips = cell_mesh.size()
        rec.update(ok=True, chips=chips, trace_s=round(t_trace, 2),
                   meta=meta, nodes=len(graph.graph.nodes),
                   **price(graph, cfg, shape, chips))
        if save_graph:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(
                    out_dir, f"{arch}__{name}__{mesh_name}.graph.py"),
                    "w") as f:
                f.write(graph.code)
        if verbose:
            r, m = rec["roofline"], rec["memory"]
            print(f"[ok]   {arch} × {name} × {mesh_name}: "
                  f"{m['per_device_total'] / 2**30:.2f} GiB/dev "
                  f"(fits={m['fits_80GB']}), "
                  f"compute={r['compute_s'] * 1e3:.2f}ms "
                  f"memory={r['memory_s'] * 1e3:.2f}ms "
                  f"coll={r['collective_s'] * 1e3:.2f}ms "
                  f"-> {r['dominant']}-bound; trace {t_trace:.0f}s")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} × {name} × {mesh_name}: {rec['error']}")
    _save(rec, out_dir)
    return rec


def _save(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{rec['variant'].replace('=','').replace(',','_')}" \
        if rec.get("variant") else ""
    path = os.path.join(
        out_dir,
        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    slim = {k: v for k, v in rec.items() if k != "trace"}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--save-graph", action="store_true",
                    help="also write each traced graph's code")
    ap.add_argument("--variant", default="",
                    help="e.g. 'mb=8,attn=dense,grad_rs=1,fsdp=0'")
    ap.add_argument("--assigned-only", action="store_true",
                    help="skip the two paper-eval models")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    if args.assigned_only:
        archs = [a for a in archs if a not in ("qwen2_7b", "qwen3_32b")]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out,
                               save_graph=args.save_graph,
                               variant=args.variant)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
