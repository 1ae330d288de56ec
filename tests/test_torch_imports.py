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
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
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
                         + [ROOT / "chip_smoke.py"],
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
