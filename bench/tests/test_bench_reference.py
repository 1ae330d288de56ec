"""The plain references against the port at smoke size, their
independence from the program, and the control's machinery."""
from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench import check, harness
from bench.tests import smoke
from bench.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]


def _spec(src, sizes):
    c = json.loads((BENCH / "configs" / src).read_text())
    c.update(sizes)
    return c


CASES = {"qwen2": ("qwen2_7b_fp32.json", smoke.DENSE, smoke.DENSE_ARCH)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_equals_the_ports_forward(name):
    from repro_torch.configs import get
    from repro_torch.models.model import forward
    src, sizes, arch_over = CASES[name]
    spec = _spec(src, sizes)
    arch = dataclasses.replace(get(spec["program"]["arch"]),
                               **dict(spec["program"]["overrides"],
                                      **arch_over))
    w = make_weights(arch, 2**32 + 3, "cpu")
    tokens = torch.randint(1, arch.vocab, (70,),
                           generator=torch.Generator().manual_seed(0))
    rows = torch.arange(70)
    ref = check.reference(spec).logits(spec, w, tokens, rows)
    port = forward(arch, w, tokens[None].int())
    port = port[0] if isinstance(port, tuple) else port
    port = port[0] if port.dim() == 3 else port
    assert torch.allclose(ref, port, atol=2e-5, rtol=1e-5), \
        (ref - port).abs().max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_have_the_ports_layout(name):
    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    src, sizes, arch_over = CASES[name]
    spec = _spec(src, sizes)
    arch = dataclasses.replace(get(spec["program"]["arch"]),
                               **dict(spec["program"]["overrides"],
                                      **arch_over))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    ours = make_weights(arch, 5, "cpu")
    theirs = init_params(arch, torch.Generator().manual_seed(5), device="cpu")
    assert shapes(ours) == shapes(theirs)
    again = make_weights(arch, 5, "cpu")
    assert torch.equal(ours["layers"]["attn"]["wq"],
                       again["layers"]["attn"]["wq"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"torch", "math", "__future__"}, path


def test_no_module_the_benchmark_loads_is_jax_or_the_jax_package(tmp_path):
    copy = smoke.make(tmp_path / "checkout")
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(copy)!r})\n"
        "from pathlib import Path\n"
        "import bench.run\n"
        "from bench import harness\n"
        f"harness.run_cell('smoke.chat', 3, 1.0, True, "
        f"t_start=time.monotonic(), device='cpu', root=Path({str(copy)!r}),"
        " log=lambda *a, **k: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=copy)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "bench" in top
    assert not top & set(harness.FORBIDDEN)


def test_control_reads_the_same_positions_as_the_check(tmp_path):
    """On the CPU TF32 does not exist, so the control reads the fp32
    reference twice and must find the served tokens first everywhere, and
    ``check`` judges it as it judges the program; on the card it is the
    TF32 reference (``control_gaps``)."""
    copy = smoke.make(tmp_path / "checkout")
    import time
    res = harness.run_cell("smoke.chat", 9, 2.0, False,
                           t_start=time.monotonic(), device="cpu",
                           root=copy, do_check=False,
                           log=lambda *a, **k: None)
    run, w = res["run"], res["weights"]
    picked = check.sample(run.cell, run, 9)
    assert picked and picked[0].output_len == max(
        r.output_len for r in run.recs if r.complete)
    assert any(r.planned.prefix >= 0 for r in picked)
    for r in picked:
        served = check.served_gaps(run.cell.config, w, r)
        ctrl = check.control_gaps(run.cell.config, w, r)
        assert served.shape == ctrl.shape == (r.output_len,)
        assert (ctrl == 0).all() and served.max() < 1e-5
    res = check.check(run.cell, run, w, 9, log=lambda *a, **k: None,
                      gaps=check.control_gaps)
    assert res["correct"] and res["requests"] == [r.planned.idx
                                                  for r in picked]


@pytest.mark.gpu
def test_the_tf32_control_fails_the_check_on_the_card():
    """At Qwen2-7B's full size, the TF32 reference put in the program's
    place comes out not correct through ``check.check``: at 1,000
    positions of a 2,000-token sequence its choices fall below the fp32
    reference's best by more than the configuration's limit somewhere,
    on each of three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get
    spec = json.loads((BENCH / "configs" / "qwen2_7b_fp32.json").read_text())
    arch = dataclasses.replace(get("qwen2_7b"),
                               **spec["program"]["overrides"])
    for seed in (1, 2, 3):
        w = make_weights(arch, seed, "cuda")
        tokens = torch.randint(1, arch.vocab, (2000,), device="cuda",
                               generator=torch.Generator("cuda")
                               .manual_seed(seed))
        torch.backends.cuda.matmul.allow_tf32 = False
        # the control reads each position after the context before it:
        # here a prompt of 1,000 tokens and 1,000 more as its continuation
        rec = SimpleNamespace(
            planned=SimpleNamespace(prompt=tokens[:1000].cpu().numpy(),
                                    idx=0, prefix=-1),
            tokens=tokens[1000:].cpu().tolist(), output_len=1000,
            complete=True, error=None)
        cell = SimpleNamespace(config=dict(spec, check=dict(
            spec["check"], include=[])))
        run = SimpleNamespace(recs=[rec])
        ctrl = check.check(cell, run, w, seed, log=lambda *a, **k: None,
                           gaps=check.control_gaps)
        assert not ctrl["correct"], ctrl["numbers"]
        assert ctrl["numbers"]["tokens_checked"]["holds"]
        del w
        torch.cuda.empty_cache()
