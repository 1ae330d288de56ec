"""The port's cost model over the traced per-rank program
(``repro_torch.launch.hlo_cost``), held against the reference's
``repro.launch.hlo_cost.analyze`` on the programs its own tests use
(``tests/test_distribution.py``), and its bytes, memory and collective
rules on small programs.

The reference's programs run in JAX in this process, on one device; the
port's are traced on meta tensors.  The collectives and the microbatch
weighting need a process group: they run on ``fake`` groups in
``tests/_torch_cost_worker.py`` processes, started together by the module
fixture, each with a time limit of its own.  Every count is exact.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_cost import analyze as ref_analyze
from repro_torch.launch import hlo_cost

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_cost_worker.py"
LIMIT_S = 240                   # each job's own time limit
JOBS = ("collectives", "weights")


def meta(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every worker job of this file, run side by side."""
    root = tmp_path_factory.mktemp("cost")
    env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "HOME": str(root)}
    t0 = time.monotonic()
    procs = {job: subprocess.Popen(
        [sys.executable, str(WORKER), job, str(root / f"{job}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=ROOT) for job in JOBS}
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
    return out


# --------------------------------------------------------------------------
# the reference's three cost tests, held against the reference
# --------------------------------------------------------------------------

def _ref(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_a_loop_of_six_matmuls_counts_as_the_reference_scan():
    def body(x, _):
        return x @ x, None

    def scanned(x):
        return jax.lax.scan(body, x, None, length=6)[0]

    def looped(x):
        for _ in range(6):
            x = x @ x
        return x

    got = hlo_cost.analyze(hlo_cost.trace(looped, meta(128, 128)))
    assert got["flops"] == _ref(scanned, (128, 128))["flops"] \
        == 6 * 2 * 128 ** 3


def test_one_product_counts_the_reference_flops_and_bytes():
    got = hlo_cost.analyze(hlo_cost.trace(lambda a, b: a @ b,
                                          meta(64, 96), meta(96, 32)))
    want = _ref(lambda a, b: a @ b, (64, 96), (96, 32))
    assert got["flops"] == want["flops"] == 2 * 64 * 96 * 32
    assert got["bytes"] == want["bytes"] == 45_056


def test_nested_loops_count_as_the_reference_nested_scans():
    def inner(x, _):
        return x @ x, None

    def outer(x, _):
        return jax.lax.scan(inner, x, None, length=3)[0], None

    def scanned(x):
        return jax.lax.scan(outer, x, None, length=4)[0]

    def looped(x):
        for _ in range(4):
            for _ in range(3):
                x = x @ x
        return x

    got = hlo_cost.analyze(hlo_cost.trace(looped, meta(64, 64)))
    assert got["flops"] == _ref(scanned, (64, 64))["flops"] \
        == 12 * 2 * 64 ** 3


# --------------------------------------------------------------------------
# the bytes rules
# --------------------------------------------------------------------------

def test_a_chain_of_views_counts_nothing():
    def views(x):
        y = x.view(16, 8).t().unsqueeze(0).expand(3, 8, 16)[1, 2:5]
        return y.permute(1, 0).squeeze().as_strided((4,), (1,)).detach()

    got = hlo_cost.analyze(hlo_cost.trace(views, meta(8, 16)))
    assert got["bytes"] == 0 and got["flops"] == 0


def test_an_elementwise_add_counts_three_tensors():
    got = hlo_cost.analyze(hlo_cost.trace(torch.add, meta(32, 64),
                                          meta(32, 64)))
    assert got["bytes"] == 3 * 32 * 64 * 4


def test_a_broadcast_operand_is_read_once():
    got = hlo_cost.analyze(hlo_cost.trace(
        lambda x, b: x + b.expand(32, 64), meta(32, 64), meta(1, 64)))
    assert got["bytes"] == (2 * 32 * 64 + 64) * 4


def test_an_inplace_write_into_a_slice_counts_twice_the_update():
    def write(buf, upd):
        buf[4:6].copy_(upd)
        return buf

    graph = hlo_cost.trace(write, meta(64, 32), meta(2, 32))
    assert hlo_cost.analyze(graph)["bytes"] == 2 * 2 * 32 * 4
    mem = hlo_cost.memory_analysis(graph)
    # the buffer comes back in place: an output that is an argument
    assert mem["alias"] == mem["output"] == 64 * 32 * 4
    assert mem["temp"] == mem["peak"] == 0


def test_an_indexed_read_counts_the_rows_it_returns():
    got = hlo_cost.analyze(hlo_cost.trace(
        lambda table, idx: table[idx], meta(1000, 64),
        meta(8, dtype=torch.int64)))
    assert got["bytes"] == 2 * 8 * 64 * 4 + 8 * 8


def test_a_factory_counts_what_it_writes():
    got = hlo_cost.analyze(hlo_cost.trace(
        lambda x: torch.zeros(16, 16, device=x.device) + x,
        meta(16, 16)))
    assert got["bytes"] == 16 * 16 * 4 + 3 * 16 * 16 * 4
    empty = hlo_cost.analyze(hlo_cost.trace(
        lambda x: torch.empty_like(x), meta(16, 16)))
    assert empty["bytes"] == 0


def test_memory_frees_each_storage_after_its_last_use():
    def chain(x):
        a = x * 2           # 4 KiB, read by b only
        b = a + 1           # 4 KiB, read by c only
        return b.sum(0)     # 256 B, the output

    mem = hlo_cost.memory_analysis(hlo_cost.trace(chain, meta(16, 64)))
    assert mem["argument"] == 16 * 64 * 4
    assert mem["output"] == 64 * 4
    assert mem["alias"] == 0
    # a dies with the node that reads it last, so a and b meet only there
    assert mem["temp"] == mem["peak"] == 2 * 16 * 64 * 4


def test_the_peak_counts_the_outputs_made_so_far():
    def prog(x):
        a = x * 2           # 4 KiB temp
        o = x + 1           # 4 KiB output, made while a lives
        return o, a.sum()   # 4 B output: a's last use

    mem = hlo_cost.memory_analysis(hlo_cost.trace(prog, meta(16, 64)))
    assert mem["output"] == 16 * 64 * 4 + 4
    assert mem["temp"] == 16 * 64 * 4
    assert mem["peak"] == 2 * 16 * 64 * 4 + 4


def test_breakdown_ranks_the_largest_movers():
    def prog(x, w):
        return (x @ w).relu()

    graph = hlo_cost.trace(prog, meta(128, 256), meta(256, 512))
    rows, full = hlo_cost.breakdown(graph, top=2)
    assert full == hlo_cost.analyze(graph)
    (top_op, trip, shape), top_b = rows[0]
    assert top_op == "aten.mm" and trip == 1 and shape == "float32[128, 512]"
    assert top_b == (128 * 256 + 256 * 512 + 128 * 512) * 4
    assert sum(b for _, b in rows) == full["bytes"]


def test_an_unknown_collective_is_refused():
    graph = hlo_cost.trace(lambda x: x * 2, meta(4))
    node = next(n for n in graph.graph.nodes if n.op == "call_function")
    node.target = torch.ops._c10d_functional.broadcast.default
    with pytest.raises(ValueError, match="no kind"):
        hlo_cost.analyze(graph)


# --------------------------------------------------------------------------
# collectives and the microbatch weighting (fake groups, worker processes)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,result_bytes", [
    ("all-gather", 8 * 64 * 4),          # Shard(0) -> Replicate()
    ("all-reduce", 8 * 64 * 4),          # Partial() -> Replicate()
    ("reduce-scatter", 64 * 4),          # Partial() -> Shard(0)
    ("all-to-all", 8 * 8 * 4),           # Shard(0) -> Shard(1)
])
def test_a_redistribution_is_one_collective_of_its_result_bytes(
        jobs, kind, result_bytes):
    got = jobs["collectives"][kind]
    coll = got["collectives"]
    assert coll["counts"] == {k: int(k == kind)
                              for k in hlo_cost.COLLECTIVES}
    assert coll[kind] == coll["total"] == result_bytes
    # the collective's bytes are in ``bytes`` too, as in the reference
    assert got["bytes"] >= result_bytes
    assert got["flops"] == 0


@pytest.mark.parametrize("mb", ["2", "4"])
def test_one_microbatch_weighted_equals_the_unrolled_loop(jobs, mb):
    res = jobs["weights"][mb]
    assert res["once"] == res["unrolled"]
    # two iterations are traced, the second weighted by the rest
    n_unrolled, n_once = res["nodes"]
    if mb == "2":
        assert res["weighted"] == 0 and n_once == n_unrolled
    else:
        assert res["weighted"] > 0 and n_once < n_unrolled
