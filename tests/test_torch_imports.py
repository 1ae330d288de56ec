"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points never fall back to the CPU on their own."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.configs, repro_torch.core\n"
        "import repro_torch.models, repro_torch.kernels\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels.build, repro_torch.kernels.kv_quant\n"
        "import repro_torch.kernels.block_gather\n"
        "import repro_torch.kernels.spec_verify\n"
        "import repro_torch.serving.transfer, repro_torch.serving.spec\n"
        "import repro_torch.sim, repro_torch.sim.replay\n"
        "import repro_torch.serving.frontend, repro_torch.launch.multi_node\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.serve_cluster\n"
        "import repro_torch.examples.shared_prefix\n"
        "import repro_torch.examples.priority_serving\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.examples.train_resume\n"
        "import repro_torch.distributed, repro_torch.launch.mesh\n"
        "import repro_torch.launch.steps\n"
        "import repro_torch.launch.hlo_cost, repro_torch.launch.dryrun\n"
        "import runpy\n"
        "runpy.run_path('tools/torch_perf_smoke.py', run_name='probe')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_dry_run_sets_no_environment_and_no_group():
    """The reference's dry run sets ``XLA_FLAGS`` at import; the port's
    changes nothing until a cell runs."""
    code = (
        "import os, sys\n"
        "before = dict(os.environ)\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_cost\n"
        "changed = sorted(k for k in set(before) | set(os.environ)\n"
        "                 if before.get(k) != os.environ.get(k))\n"
        "print(changed, dist.is_initialized())\n"
        "sys.exit(1 if changed or dist.is_initialized() else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _absolute_imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tools" / "torch_perf_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _absolute_imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.core import EngineConfig, SlideBatching
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.serving import (Engine, KVTierStore, PagedKVPool,
                                     TransferWorker)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, EngineConfig(), SlideBatching())
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVPool(cfg, 8, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        TransferWorker()
    with pytest.raises(RuntimeError, match="cuda"):
        KVTierStore(block_bytes=1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke"])


def test_service_tier_entry_points_raise_without_a_card(monkeypatch):
    """The async tier, the replay bridge and the examples run on the card
    unless they are asked for the CPU."""
    from repro_torch.examples import serve_cluster, shared_prefix
    from repro_torch.launch import serve
    from repro_torch.sim.replay import smoke_frontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--mode", "frontend", "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        smoke_frontend(1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cluster.main(["--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        shared_prefix.main(["--smoke"])


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """The training launcher and the resume example run on the card
    unless they are asked for the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.examples import train_resume
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.train(get_smoke("qwen1_5_0_5b"), steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        train_resume.main(["--steps", "2"])


def test_mesh_and_step_builders_raise_without_a_card(monkeypatch):
    """The meshes and the sharded steps run on the card unless they are
    given the CPU: with no card they raise before touching a process
    group."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.launch import mesh, steps

    class FakeMesh:
        shape = {"data": 1, "model": 1}
        axis_names = ("data", "model")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen1_5_0_5b")
    policy = ShardingPolicy(FakeMesh())
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_debug_mesh((1, 1))
    for build in (steps.build_train_step, steps.build_prefill_step,
                  steps.build_serve_step):
        with pytest.raises(RuntimeError, match="cuda"):
            build(cfg, policy)
    for shape in steps.SHAPES:
        with pytest.raises(RuntimeError, match="cuda"):
            steps.build_cell(cfg, shape, policy)
