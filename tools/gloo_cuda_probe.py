"""Which collectives gloo carries for CUDA tensors on two ranks of one card.

    python3 tools/gloo_cuda_probe.py

NCCL refuses two ranks on one device, so a multi-rank world on a machine
with one GPU can only be gloo.  Each probe runs in a fresh pair of
processes, both on ``cuda:0``, meeting through a ``FileStore``: a
collective that crashes its process (a signal) cannot hide the others.
The probes are the c10d collectives, the functional ones DTensor issues
(``torch.distributed._functional_collectives``), and DTensor
redistributions on a (1, 2) mesh.  Prints one line per probe, ``ok``,
``refused`` (an exception) or ``crashed`` (the process died on a signal),
then the torch version and the card.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

WORLD = 2


def probe(name: str, rank: int) -> str:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
    group = dist.group.WORLD
    c10d = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(WORLD)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * WORLD, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // WORLD, device="cuda"), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty(8 // WORLD, device="cuda") for _ in range(WORLD)],
            list(x.chunk(WORLD))),
        "funcol_all_gather": lambda: funcol.all_gather_tensor(
            x, 0, group).wait(),
        "funcol_all_reduce": lambda: funcol.all_reduce(
            x, "sum", group).wait(),
        "funcol_all_reduce_max": lambda: funcol.all_reduce(
            x, "max", group).wait(),
        "funcol_reduce_scatter": lambda: funcol.reduce_scatter_tensor(
            x, "sum", 0, group).wait(),
        "funcol_all_to_all": lambda: funcol.all_to_all_single(
            x, None, None, group).wait(),
    }
    if name in c10d:
        c10d[name]()
    else:
        src, dst = {"dtensor_shard_to_replicate": (Shard(1), Replicate()),
                    "dtensor_partial_to_replicate": (Partial(), Replicate()),
                    "dtensor_partial_to_shard": (Partial(), Shard(0)),
                    "dtensor_shard_to_shard": (Shard(0), Shard(1))}[name]
        mesh = init_device_mesh("cuda", (1, WORLD),
                                mesh_dim_names=("data", "model"))
        full = torch.arange(32, dtype=torch.float32,
                            device="cuda").reshape(4, 8)
        local = full.chunk(WORLD, src.dim)[rank] if src.is_shard() else full
        d = DTensor.from_local(local, mesh, (Replicate(), src),
                               run_check=False)
        d.redistribute(mesh, (Replicate(), dst)).to_local()
    torch.cuda.synchronize()
    return "ok"


PROBES = ("all_reduce", "all_reduce_max", "broadcast", "all_gather",
          "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "all_to_all", "funcol_all_gather",
          "funcol_all_reduce", "funcol_all_reduce_max",
          "funcol_reduce_scatter", "funcol_all_to_all",
          "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
          "dtensor_partial_to_shard", "dtensor_shard_to_shard")


def rank_main(name: str, rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        print(json.dumps(probe(name, rank)), flush=True)
    except Exception as e:  # noqa: BLE001 -- a refusal is the answer
        print(json.dumps(f"refused: {type(e).__name__}: {e}"[:300]),
              flush=True)
    os._exit(0)


def main() -> None:
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    import torch
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe: needs a CUDA card")
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    procs = {name: [subprocess.Popen(
        [sys.executable, __file__, "--rank", name, str(r),
         os.path.join(tmp, name)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True) for r in range(WORLD)]
        for name in PROBES}
    for name, ranks in procs.items():
        said = []
        for p in ranks:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            lines = out.strip().splitlines()
            said.append(f"crashed (signal {-p.returncode})"
                        if p.returncode and p.returncode < 0
                        else json.loads(lines[-1]) if lines
                        else f"no answer (exit {p.returncode})")
        verdict = said[0] if len(set(said)) == 1 else " / ".join(said)
        print(f"{name}: {verdict}", flush=True)
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}",
          flush=True)


if __name__ == "__main__":
    main()
