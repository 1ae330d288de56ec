"""One rank of a CPU gloo world for ``tests/test_torch_dist.py``.

    python tests/_torch_dist_worker.py JOB RANK WORLD STORE OUT

The ranks meet through a ``FileStore`` at STORE (no port), run JOB and
write what they measured to OUT/rank<RANK>.json; the test asserts on it.
Jobs:
  steps-DxM, steps-PxDxM  the sharded train / prefill / serve steps of
          the SMOKE dense and MoE configs (``launch.steps``) on a (D, M)
          ``("data", "model")`` or a (P, D, M) ``("pod", "data",
          "model")`` mesh against the one-process port functions; the
          local shard of every leaf the specs shard; a one-process
          checkpoint restored with ``shardings=`` into the same step.  On
          (2, 2) the dense train step also runs with ``grad_rs`` and 2
          microbatches of the same shape (a batch of 2 x BATCH), and on
          (2, 2, 2) with 2 microbatches that dp = 4 does not divide; on
          (1, 4) the SMOKE GQA config (2 kv heads over 4 ranks), the
          same with 6 heads (q cannot split over the heads, so the
          attention cores split the query rows) and the SMOKE hybrid (SSD
          heads, a ring cache past its window) run.
          Every DTensor the steps create, the intermediates of decomposed
          ops included, is recorded; those with a ``_StridedShard``
          placement (torch 2.13 makes one where 2.11 refuses a view) or a
          non-default shard order are listed per step
  debug   ``make_debug_mesh((4, 2))`` on a world of 8
  fake    ``make_production_mesh`` on a ``fake`` process group of 256 and
          of 512 ranks in this one process
Imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingPolicy, mesh_axes)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.model import (decode_step, init_params,  # noqa: E402
                                      prefill)
from repro_torch.training import (CheckpointManager, init_adamw,  # noqa: E402
                                  make_train_step)
from repro_torch.training.tree import leaves  # noqa: E402

ARCHS = ("qwen1_5_0_5b", "olmoe_1b_7b")
# a model axis wider than the kv heads: the SMOKE GQA config (4 heads, 2
# kv heads) on 4 ranks gathers k / v and q's head groups before it splits
# them, and pins the GQA repeat's gradient (models.layers ``splittable``,
# ``split_back``)
WIDE_ARCHS = ("qwen2_7b", "qwen2_7b+h6", "hymba_1_5b")
# SMOKE configs changed for one case: "+h6", 6 heads
VARIANTS = {"qwen2_7b+h6": dict(n_heads=6)}
BATCH, SEQ = 4, 16                   # train and prefill
PROMPT, CACHE, DECODE = 8, 32, 8     # serve: prompt, cache capacity, tokens


STRIDED: list = []       # DTensors with a _StridedShard or out of order


def out_of_order(spec) -> bool:
    """Whether ``spec`` splits a dim over mesh dims in another order than
    left to right (torch 2.13's ``shard_order``, which is None where a
    ``_StridedShard`` stands for it; 2.11 may have none)."""
    order = getattr(spec, "shard_order", None) or ()
    return any(list(e.mesh_dims) != sorted(e.mesh_dims) for e in order)


def record_strided() -> None:
    """Record each DTensor made from now on whose placements hold a
    ``_StridedShard`` or whose spec has a non-default shard order: either
    sends DTensor's redistributions through its graph-based planner, and
    torch 2.11 refuses the views that make a ``_StridedShard``
    (``DTensor.__init__`` runs for every DTensor that an op, a
    redistribution or ``from_local`` makes)."""
    init = DTensor.__init__

    def recording(self, *args, **kwargs):
        spec = self._spec
        if any(isinstance(p, _StridedShard) for p in spec.placements) \
                or out_of_order(spec):
            STRIDED.append(f"{tuple(self.shape)} {spec.placements} "
                           f"{getattr(spec, 'shard_order', None)}")
        init(self, *args, **kwargs)

    DTensor.__init__ = recording


def strided() -> list:
    """The ``_StridedShard`` DTensors recorded since the last call."""
    out = list(STRIDED)
    STRIDED.clear()
    return out


def full(x) -> torch.Tensor:
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def max_err(got, want) -> float:
    return float((full(got).float() - full(want).float()).abs().max())


def leaf_rel(got, want) -> float:
    """Worst leaf's max |got - want| over its max |want|."""
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        scale = float(full(b).abs().max())
        err = max_err(a, b)
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def max_abs(got, want) -> float:
    return max(max_err(a, b) for a, b in zip(leaves(got), leaves(want)))


def shard_faults(tree, shardings) -> list:
    """Leaves whose local tensor is not numel / extent, the extent being
    the product of the mesh axes their spec names."""
    bad = []
    sizes = None
    for x, s in zip(leaves(tree), leaves(shardings)):
        sizes = sizes or mesh_axes(s.mesh)
        extent = math.prod(sizes[n] for e in s.spec if e is not None
                           for n in (e if isinstance(e, tuple) else (e,)))
        local = x.to_local().numel()
        if local * extent != x.numel() or \
                tuple(x.placements) != s.placements:
            bad.append(f"{tuple(x.shape)} {s.spec}: local {local}")
    return bad


def names_of(placements) -> list:
    """"S(d)" for a shard of dim d, "R" for a replica, per mesh dim."""
    return [f"S({q.dim})" if q.is_shard() else "R" if q.is_replicate()
            else str(q) for q in placements]


def batch_of(cfg, seed: int, b: int, s: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g),
            "labels": torch.randint(0, cfg.vocab, (b, s), generator=g)}


def run_steps(mesh, arch: str, out_dir: Path, variant: dict,
              train_only: bool = False, batch: int = BATCH) -> dict:
    cfg = dataclasses.replace(get_smoke(arch.split("+")[0]),
                              **VARIANTS.get(arch, {}))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    res: dict = {}

    # train: one step, sharded against one process
    pol = ShardingPolicy(mesh, mode="train")
    step, structs, meta = steps.build_train_step(cfg, pol, device="cpu",
                                                 **variant)
    mb = meta["microbatches"]
    batch = batch_of(cfg, 1, batch, SEQ)
    p_in = steps.place(params, step.in_shardings[0])
    o_in = steps.place(init_adamw(params), step.in_shardings[1])
    p_s, o_s, m_s = step(p_in, o_in, batch)
    one = make_train_step(cfg, attn_impl="chunked", remat=True,
                          microbatches=mb)
    p_1, o_1, m_1 = one(params, init_adamw(params), batch)
    res["train"] = {
        "microbatches": mb,
        "loss": [float(full(m_s["loss"])), float(m_1["loss"])],
        "grad_norm": [float(full(m_s["grad_norm"])),
                      float(m_1["grad_norm"])],
        # mu = (1 - b1) x the clipped gradient after one step from zero
        "grad_rel": leaf_rel(o_s.mu, o_1.mu),
        "nu_rel": leaf_rel(o_s.nu, o_1.nu),
        "param_abs": max(max_abs(p_s, p_1), max_abs(o_s.master,
                                                    o_1.master)),
        "step": int(full(o_s.step)),
        "shard_faults": (shard_faults(p_in, step.in_shardings[0])
                         + shard_faults(p_s, step.out_shardings[0])
                         + shard_faults(o_s.mu, step.out_shardings[1].mu)),
        "sharded_leaves": sum(any(e is not None for e in s.spec)
                              for s in leaves(step.in_shardings[0])),
        # where the batch and a weight lie, one placement per mesh dim
        "placements": {
            "tokens": names_of(step.in_shardings[2]["tokens"].placements),
            "wq": names_of(p_in["layers"]["attn"]["wq"].placements)},
        "struct_dtype": str(leaves(structs[0])[0].dtype),
        "struct_device": str(leaves(structs[0])[0].device),
        "strided": strided(),
    }

    # the same step from a one-process checkpoint, restored sharded
    ck = out_dir / f"ckpt_{arch}_{len(variant)}"
    if dist.get_rank() == 0:
        CheckpointManager(str(ck)).save(0, {"p": params,
                                            "o": init_adamw(params)})
    dist.barrier()
    tree, _ = CheckpointManager(str(ck)).restore(
        {"p": structs[0], "o": structs[1]},
        shardings={"p": step.in_shardings[0], "o": step.in_shardings[1]})
    p_r, o_r, m_r = step(tree["p"], tree["o"], batch)
    res["restore"] = {
        "param_abs": max_abs(p_r, p_s),
        "loss": [float(full(m_r["loss"])), float(full(m_s["loss"]))],
        "shard_faults": shard_faults(tree["p"], step.in_shardings[0]),
        "strided": strided(),
    }
    if train_only:
        return res

    # prefill at a reduced shape; a hybrid's runs past its window, so
    # that its ring cache turns
    seq = SEQ + cfg.window // 2 if cfg.window else SEQ
    pol = ShardingPolicy(mesh, mode="serve")
    shape = steps.ShapeSpec("prefill_test", "prefill", seq, BATCH)
    step, _, _ = steps.build_prefill_step(cfg, pol, shape, device="cpu")
    toks = batch_of(cfg, 2, BATCH, seq)["tokens"]
    logits_s, cache_s = step(steps.place(params, step.in_shardings[0]),
                             toks)
    logits_1, cache_1 = prefill(cfg, params, toks, max_seq=seq,
                                attn_impl="chunked")
    res["prefill"] = {
        "logits_abs": max_err(logits_s, logits_1),
        "cache_abs": max(max_err(cache_s[k], cache_1[k])
                         for k in cache_1 if k != "len"),
        "len_equal": bool(torch.equal(full(cache_s["len"]),
                                      cache_1["len"])),
        "shard_faults": (shard_faults([logits_s], [step.out_shardings[0]])
                         + shard_faults(cache_s, step.out_shardings[1])),
        "strided": strided(),
    }

    # serve: greedy decode from a prefilled cache, sharded against one
    # process, each side choosing its own tokens
    shape = steps.ShapeSpec("decode_test", "decode", CACHE, BATCH)
    step, _, _ = steps.build_serve_step(cfg, pol, shape, device="cpu")
    prompt = batch_of(cfg, 3, BATCH, PROMPT)["tokens"]
    _, cache_1 = prefill(cfg, params, prompt, max_seq=CACHE)
    cache_s = steps.place({k: v.clone() for k, v in cache_1.items()},
                          step.in_shardings[1])
    p_in = steps.place(params, step.in_shardings[0])
    tok_1 = tok_s = prompt[:, -1]
    errs, toks_1, toks_s, faults = [], [], [], []
    for _ in range(DECODE):
        logits_s, cache_s = step(p_in, cache_s, tok_s)
        logits_1, cache_1 = decode_step(cfg, params, cache_1, tok_1)
        errs.append(max_err(logits_s, logits_1))
        tok_s = full(logits_s).argmax(-1)
        tok_1 = logits_1.argmax(-1)
        toks_s.append(tok_s.tolist())
        toks_1.append(tok_1.tolist())
        faults += shard_faults(cache_s, step.out_shardings[1])
    res["serve"] = {
        "logits_abs": max(errs),
        "tokens": [toks_s, toks_1],
        "cache_abs": max(max_err(cache_s[k], cache_1[k])
                         for k in cache_1 if k != "len"),
        "shard_faults": faults,
        "strided": strided(),
    }
    return res


def job_steps(out_dir: Path, shape: tuple) -> dict:
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = make_debug_mesh(shape, axes, device_type="cpu")
    if shape == (1, 4):
        return {arch: run_steps(mesh, arch, out_dir, {"microbatches": 1})
                for arch in WIDE_ARCHS}
    out = {arch: run_steps(mesh, arch, out_dir, {}) for arch in ARCHS}
    if shape == (2, 2):
        out[f"{ARCHS[0]}+mb2+grad_rs"] = run_steps(
            mesh, ARCHS[0], out_dir, {"microbatches": 2, "grad_rs": True},
            train_only=True, batch=2 * BATCH)
    if shape == (2, 2, 2):
        # dp = 4 does not divide 2 microbatches: each rank's own rows
        # make its share of a microbatch (``split_microbatches``)
        out[f"{ARCHS[0]}+mb2"] = run_steps(
            mesh, ARCHS[0], out_dir, {"microbatches": 2}, train_only=True,
            batch=2 * BATCH)
    return out


def job_debug(out_dir: Path) -> dict:
    mesh = make_debug_mesh((4, 2), ("data", "model"), device_type="cpu")
    return {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
            "coord": mesh.get_coordinate(),
            "mesh": mesh.mesh.tolist()}


def job_fake(out_dir: Path) -> dict:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    out = {}
    for multi_pod, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        out[str(world)] = {"shape": list(mesh.shape),
                           "names": list(mesh.mesh_dim_names)}
        try:
            make_debug_mesh((4, 2), device_type="cpu")
        except ValueError as e:
            out[str(world)]["wrong_size"] = str(e)
        dist.destroy_process_group()
    return out


def main() -> None:
    job, rank, world, store, out = sys.argv[1:6]
    rank, world, out_dir = int(rank), int(world), Path(out)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    if job == "fake":
        res = job_fake(out_dir)
    else:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world)
        if job == "debug":
            res = job_debug(out_dir)
        else:
            record_strided()
            shape = tuple(int(n) for n in job.split("-")[1].split("x"))
            res = job_steps(out_dir, shape)
        dist.barrier()
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    # the results are on disk: exit without the interpreter's teardown
    os._exit(0)


if __name__ == "__main__":
    main()
