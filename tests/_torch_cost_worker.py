"""One job of ``tests/test_torch_hlo_cost.py`` or
``tests/test_torch_dryrun.py``, run in a process of its own.

    python tests/_torch_cost_worker.py JOB OUT

Port jobs run on ``fake`` process groups (no port, no peer) and import
torch and the port only; ``ref42`` imports JAX and the reference with 8
host devices (set by the caller's ``XLA_FLAGS``).  Each job writes what
it measured to OUT as JSON.  Jobs:
  collectives  one redistribution of each kind on a 1-D mesh of 8
  weights      a SMOKE train step at 2 and 4 microbatches on (4, 2),
               traced unrolled and with ``hlo_cost.one_microbatch``
  port1        the one-rank SMOKE steps (qwen serve / prefill / train,
               olmoe serve) on a (1, 1) mesh
  port42       the SMOKE serve steps on (4, 2), with each MLP's and each
               router's flops and the all-gathers' result shapes
  ref42        the reference's SMOKE serve steps on a (4, 2)
               ``jax.sharding.Mesh`` of 8 host devices
  port222      the SMOKE qwen and olmoe serve / prefill / train steps on
               the (2, 2, 2) ("pod", "data", "model") mesh
  ref222       the reference's same steps on a (2, 2, 2)
               ``jax.sharding.Mesh`` of 8 host devices
  cells        ``dryrun.run_cell`` on (4, 2): one serve cell of each
               family
  train_cell   ``dryrun.run_cell`` on (4, 2): a train cell of 2
               microbatches
  production   one SMOKE cell on each production mesh (256 and 512 ranks)
               and a SMOKE train cell on the 512, each with the number of
               redistributions DTensor planned with its graph-based
               planner
  loss         the cross-entropy and its gradient on SMOKE logits split
               over (2, 4), with the element count of each all-gather's
               result
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCHS = {"dense": "qwen1_5_0_5b", "moe": "olmoe_1b_7b",
         "ssm": "mamba2_1_3b", "hybrid": "hymba_1_5b",
         "encdec": "whisper_small"}
SERVE = ("decode_8x128", "decode", 128, 8)       # batch 8, cache 128
PREFILL = ("prefill_8x128", "prefill", 128, 8)
TRAIN = ("train_8x128", "train", 128, 8)
# records whose file names both packages' ``_save`` must give alike
SAVED = [{"arch": "qwen2_7b", "shape": "train_4k", "mesh": "single",
          "variant": ""},
         {"arch": "qwen2_7b", "shape": "train_4k", "mesh": "multi",
          "variant": "mb=8,attn=dense,grad_rs=1"},
         {"arch": "olmoe_1b_7b", "shape": "decode_32k", "mesh": "single",
          "variant": "fsdp=0", "trace": "dropped"}]


def _world(size: int):
    from repro_torch.launch.dryrun import fake_world
    return fake_world(size)


def _mesh(shape):
    from repro_torch.launch.mesh import make_debug_mesh
    axes = ("pod", "data", "model")[-len(shape):]
    return make_debug_mesh(shape, axes, device_type="cpu")


def _cost(cfg, spec, mesh, **kw) -> dict:
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import hlo_cost, steps

    shape = steps.ShapeSpec(*spec)
    mode = "train" if shape.kind == "train" else "serve"
    step, structs, _ = steps.build_cell(cfg, shape,
                                        ShardingPolicy(mesh, mode=mode),
                                        device="cpu", **kw)
    graph = hlo_cost.trace_step(step, structs)
    return {**hlo_cost.analyze(graph),
            "memory": hlo_cost.memory_analysis(graph)}


def job_collectives() -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch import hlo_cost

    cases = {"all-gather": (Shard(0), Replicate()),
             "all-reduce": (Partial(), Replicate()),
             "reduce-scatter": (Partial(), Shard(0)),
             "all-to-all": (Shard(0), Shard(1))}
    local = {"all-gather": (1, 64), "all-reduce": (8, 64),
             "reduce-scatter": (8, 64), "all-to-all": (1, 64)}
    out = {}
    with _world(8):
        mesh = init_device_mesh("cpu", (8,))
        for name, (src, dst) in cases.items():
            def fn(t, src=src, dst=dst):
                d = DTensor.from_local(t, mesh, [src], shape=(8, 64),
                                       stride=(64, 1), run_check=False)
                return d.redistribute(mesh, [dst]).to_local()

            graph = hlo_cost.trace(fn, torch.empty(local[name],
                                                   device="meta"))
            out[name] = hlo_cost.analyze(graph)
    return out


def job_weights() -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import hlo_cost, steps

    cfg = get_smoke("qwen1_5_0_5b")
    out = {}
    with _world(8):
        mesh = _mesh((4, 2))
        pol = ShardingPolicy(mesh, mode="train")
        for mb in (2, 4):
            # the same 4-row microbatch at either count
            shape = steps.ShapeSpec("t", "train", 64, 4 * mb)
            step, structs, _ = steps.build_train_step(
                cfg, pol, microbatches=mb, shape=shape, device="cpu")
            unrolled = hlo_cost.trace_step(step, structs)
            with hlo_cost.one_microbatch():
                once = hlo_cost.trace_step(step, structs)
            out[str(mb)] = {
                "unrolled": hlo_cost.analyze(unrolled),
                "once": hlo_cost.analyze(once),
                "nodes": [len(unrolled.graph.nodes), len(once.graph.nodes)],
                "weighted": sum(n.meta.get("trip", 1) > 1
                                for n in once.graph.nodes)}
    return out


def job_port1() -> dict:
    from repro_torch.configs import get_smoke

    out = {}
    with _world(1):
        mesh = _mesh((1, 1))
        qwen = get_smoke("qwen1_5_0_5b")
        out["qwen1_5_0_5b/serve"] = _cost(qwen, SERVE, mesh)
        out["qwen1_5_0_5b/prefill"] = _cost(qwen, PREFILL, mesh)
        out["qwen1_5_0_5b/train"] = _cost(qwen, TRAIN, mesh,
                                          microbatches=1)
        out["olmoe_1b_7b/serve"] = _cost(get_smoke("olmoe_1b_7b"), SERVE,
                                         mesh)
    return out


def job_port42() -> dict:
    """The serve steps on (4, 2), with the flops of each call of the
    dense MLP (``swiglu``) and of each MoE router matmul, found by the
    graph's node count around each call."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import hlo_cost, steps
    from repro_torch.models import model, moe

    spans = []

    def spanned(fn, kind):
        def wrapper(*args, **kwargs):
            if not hlo_cost._RECORDING:          # building the stand-ins
                return fn(*args, **kwargs)
            graph = hlo_cost._RECORDING[-1].graph
            n0 = len(graph.nodes)
            out = fn(*args, **kwargs)
            spans.append((kind, n0, len(graph.nodes)))
            return out
        return wrapper

    model.swiglu = spanned(model.swiglu, "mlp")
    moe.route = spanned(moe.route, "router")
    out = {}
    with _world(8):
        mesh = _mesh((4, 2))
        for arch in ("qwen1_5_0_5b", "olmoe_1b_7b"):
            cfg = get_smoke(arch)
            spans.clear()
            step, structs, _ = steps.build_cell(
                cfg, steps.ShapeSpec(*SERVE),
                ShardingPolicy(mesh, mode="serve"), device="cpu")
            graph = hlo_cost.trace_step(step, structs)
            nodes = list(graph.graph.nodes)
            per_span = {}
            for kind, a, b in spans:
                per_span.setdefault(kind, []).append(
                    sum(hlo_cost.node_cost(n)[0] for n in nodes[a:b]))
            gathers = [list(n.meta["val"].shape) for n in nodes
                       if hlo_cost.node_cost(n)[2] == "all-gather"]
            out[arch] = {**hlo_cost.analyze(graph),
                         "memory": hlo_cost.memory_analysis(graph),
                         "spans": per_span, "gathers": gathers}
    return out


def job_ref42() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_smoke
    from repro.distributed.sharding import ShardingPolicy
    from repro.launch import hlo_cost, steps

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    out = {}
    for arch in ("qwen1_5_0_5b", "olmoe_1b_7b"):
        cfg = get_smoke(arch)
        pol = ShardingPolicy(mesh=mesh, mode="serve")
        with mesh:
            jitted, structs, _ = steps.build_serve_step(cfg, pol,
                                                        "decode_32k")
            compiled = jitted.lower(
                structs[0], steps.cache_struct(cfg, SERVE[3], SERVE[2]),
                jax.ShapeDtypeStruct((SERVE[3],), jnp.int32)).compile()
        acc = hlo_cost.analyze(compiled.as_text())
        out[arch] = {**acc, "argument": int(
            compiled.memory_analysis().argument_size_in_bytes)}
    # the reference's file names (imported last: the module sets
    # XLA_FLAGS, which no longer matters once the devices exist)
    import tempfile

    from repro.launch import dryrun
    with tempfile.TemporaryDirectory() as d:
        for rec in SAVED:
            dryrun._save(dict(rec), d)
        out["saved"] = sorted(p.name for p in Path(d).iterdir())
    return out


def job_port222() -> dict:
    from repro_torch.configs import get_smoke

    kinds = {"serve": (SERVE, {}), "prefill": (PREFILL, {}),
             "train": (TRAIN, {"microbatches": 1})}
    out = {}
    with _world(8):
        mesh = _mesh((2, 2, 2))
        for arch in ("qwen1_5_0_5b", "olmoe_1b_7b"):
            for kind, (spec, kw) in kinds.items():
                out[f"{arch}/{kind}"] = _cost(get_smoke(arch), spec, mesh,
                                              **kw)
    return out


def job_ref222() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_smoke
    from repro.distributed.sharding import ShardingPolicy
    from repro.launch import hlo_cost, steps

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("pod", "data", "model"))
    sds = jax.ShapeDtypeStruct
    out = {}
    for arch in ("qwen1_5_0_5b", "olmoe_1b_7b"):
        cfg = get_smoke(arch)
        for kind in ("serve", "prefill", "train"):
            pol = ShardingPolicy(mesh=mesh, mode="train" if kind == "train"
                                 else "serve")
            with mesh:
                if kind == "train":
                    jitted, st, _ = steps.build_train_step(cfg, pol,
                                                           microbatches=1)
                    lowered = jitted.lower(st[0], st[1], {
                        k: sds((TRAIN[3], TRAIN[2]), jnp.int32)
                        for k in ("tokens", "labels")})
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
            out[f"{arch}/{kind}"] = {
                **hlo_cost.analyze(compiled.as_text()),
                "argument": int(
                    compiled.memory_analysis().argument_size_in_bytes)}
    return out


def job_cells(out_dir: str) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import ShapeSpec

    out = {}
    with _world(8):
        mesh = _mesh((4, 2))
        for family, arch in ARCHS.items():
            out[family] = dryrun.run_cell(
                arch, ShapeSpec(*SERVE), False, out_dir, verbose=False,
                cfg=get_smoke(arch), mesh=mesh)
    return out


def job_train_cell(out_dir: str) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import ShapeSpec

    with _world(8):
        return dryrun.run_cell(
            "qwen1_5_0_5b", ShapeSpec("train_16x32", "train", 32, 16),
            False, out_dir, verbose=False, variant="mb=2",
            cfg=get_smoke("qwen1_5_0_5b"), mesh=_mesh((4, 2)))


def count_graph_plans() -> list:
    """Count, from now on, each redistribution plan DTensor makes with its
    graph-based planner: the one it is forced to take for a spec with a
    ``_StridedShard`` or a non-default shard order, whose cost grows
    with the mesh's dims (torch 2.13's ``_redistribute``)."""
    from torch.distributed.tensor import _redistribute as red

    planned = [0]
    make = red.DTensorRedistributePlanner.generate_graph_based_transform_infos

    def counting(self, *args, **kwargs):
        planned[0] += 1
        return make(self, *args, **kwargs)

    red.DTensorRedistributePlanner.generate_graph_based_transform_infos = \
        counting
    return planned


def job_production(out_dir: str) -> dict:
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import ShapeSpec

    planned = count_graph_plans()
    cfg = get_smoke("qwen1_5_0_5b")
    cells = {"single": ShapeSpec("decode_512x64", "decode", 64, 512),
             "multi": ShapeSpec("decode_512x64", "decode", 64, 512),
             "multi_train": ShapeSpec("train_64x64", "train", 64, 64)}
    out = {}
    for name, shape in cells.items():
        planned[0] = 0
        out[name] = dryrun.run_cell("qwen1_5_0_5b", shape,
                                    name.startswith("multi"), out_dir,
                                    verbose=False, cfg=cfg)
        out[name]["graph_plans"] = planned[0]
    return out


def job_loss() -> dict:
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke
    from repro_torch.launch import hlo_cost
    from repro_torch.training.train import softmax_cross_entropy

    b, s, vocab = 4, 16, get_smoke("qwen1_5_0_5b").vocab
    with _world(8):
        mesh = _mesh((2, 4))

        def loss_and_grad(logits, labels):
            logits = DTensor.from_local(
                logits.requires_grad_(), mesh, [Shard(0), Shard(2)],
                shape=(b, s, vocab), stride=(s * vocab, vocab, 1),
                run_check=False)
            labels = DTensor.from_local(labels, mesh,
                                        [Shard(0), Replicate()],
                                        shape=(b, s), stride=(s, 1),
                                        run_check=False)
            with implicit_replication():      # as the train step runs it
                loss = softmax_cross_entropy(logits, labels).mean()
                (grad,) = torch.autograd.grad(loss, logits)
            return loss.to_local(), grad.to_local()

        graph = hlo_cost.trace(
            loss_and_grad, torch.empty(b // 2, s, vocab // 4, device="meta"),
            torch.empty(b // 2, s, dtype=torch.int64, device="meta"))
        gathers = [n.meta["val"].numel() for n in graph.graph.nodes
                   if hlo_cost.node_cost(n)[2] == "all-gather"]
    # a rank's rows of the logits, whole over the vocabulary
    return {"gathers": gathers, "rows_x_vocab": b // 2 * s * vocab}


def main() -> None:
    import torch
    torch.set_num_threads(1)
    job, out = sys.argv[1], Path(sys.argv[2])
    if job in ("cells", "train_cell", "production"):
        res = globals()[f"job_{job}"](str(out.parent / job))
    else:
        res = globals()[f"job_{job}"]()
    out.write_text(json.dumps(res))


if __name__ == "__main__":
    main()
