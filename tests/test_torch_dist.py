"""The port's sharded steps on CPU gloo worlds (``launch.steps``,
``launch.mesh``, ``distributed.sharding``), held against the one-process
port functions.

Every world runs once, in the module fixture: each is a set of
``tests/_torch_dist_worker.py`` processes meeting through a ``FileStore``
under ``tmp_path`` (no port), with a time limit of its own; the tests
assert on what each rank wrote.  The four step worlds, meshes (1, 2),
(2, 1), (2, 2) and (1, 4) on 2, 2, 4 and 4 ranks (the last with the SMOKE
GQA config, 2 kv heads over 4 ranks, the same with 6 heads, whose query
rows split where its heads cannot, and the SMOKE hybrid: SSD heads and a
ring cache on 4 ranks), run side by side, then the world of 8;
``make_production_mesh`` runs on ``fake`` process groups of 256 and 512
ranks in one process.

Tolerances, fp32 throughout:
  * logits and caches 2e-5 absolute (``chip_smoke.py``'s fp32 gate);
  * the loss and the gradient norm 1e-5 relative, the gradients (AdamW's
    first moment after one step from zero: (1 - b1) x the clipped
    gradient) 1e-4 of each leaf's largest entry, one-step parameters and
    the fp32 master copy 1e-4 absolute: the tolerances the port's training
    is held to against the reference (``tests/test_torch_training.py``);
  * greedy tokens, and a restored checkpoint's step, exactly.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
STEP_WORLDS = {"1x2": 2, "2x1": 2, "2x2": 4, "1x4": 4}
ARCHS = ("qwen1_5_0_5b", "olmoe_1b_7b")
# the model axis wider than the kv heads (2 of them over 4 ranks), the
# same with 6 heads (the query rows split, not the heads), and the
# hybrid's SSD and ring cache split 4 ways
WORLD_ARCHS = {"1x4": ("qwen2_7b", "qwen2_7b+h6", "hymba_1_5b")}
LIMIT_S = 240                   # each world's own time limit
LOGITS_ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-4


class World:
    """The processes of one world, started now."""

    def __init__(self, job: str, size: int, root: Path):
        self.job, self.size = job, size
        self.dir = root / job
        self.dir.mkdir()
        env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
               "HOME": str(root)}
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), job, str(r), str(size),
             str(self.dir / "store"), str(self.dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT) for r in range(size)]
        self.t0 = time.monotonic()

    def results(self) -> list:
        """Wait within the world's time limit; every rank's results."""
        logs = []
        for p in self.procs:
            left = max(1.0, LIMIT_S - (time.monotonic() - self.t0))
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                pytest.fail(f"world {self.job} passed its {LIMIT_S} s limit")
            logs.append(out.decode(errors="replace"))
        self.seconds = time.monotonic() - self.t0
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"{self.job} rank {r}:\n{log[-4000:]}"
        return [json.loads((self.dir / f"rank{r}.json").read_text())
                for r in range(self.size)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("worlds")
    t0 = time.monotonic()
    started = [World(f"steps-{m}", n, root) for m, n in STEP_WORLDS.items()]
    started.append(World("fake", 1, root))
    out = {w.job: w.results() for w in started}
    debug = World("debug", 8, root)
    out["debug"] = debug.results()
    print(f"\nspawned worlds: {time.monotonic() - t0:.1f} s")
    return out


def ranks(worlds, mesh: str, key: str):
    return [r[key] for r in worlds[f"steps-{mesh}"]]


CELLS = [(m, a) for m in STEP_WORLDS for a in WORLD_ARCHS.get(m, ARCHS)] \
    + [("2x2", "qwen1_5_0_5b+mb2+grad_rs")]
IDS = [f"{m}-{a}" for m, a in CELLS]


def test_debug_mesh_on_a_world_of_8(worlds):
    res = worlds["debug"]
    for r in res:
        assert r["shape"] == [4, 2]
        assert r["names"] == ["data", "model"]
        assert r["mesh"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # each rank sits at its own coordinate, row-major
    assert [r["coord"] for r in res] == [[i // 2, i % 2] for i in range(8)]


@pytest.mark.parametrize("world,shape,names", [
    ("256", [16, 16], ["data", "model"]),
    ("512", [2, 16, 16], ["pod", "data", "model"])])
def test_production_mesh_on_a_fake_group(worlds, world, shape, names):
    (res,) = worlds["fake"]
    assert res[world]["shape"] == shape
    assert res[world]["names"] == names
    assert "needs 8 ranks" in res[world]["wrong_size"]


@pytest.mark.parametrize("mesh,arch", CELLS, ids=IDS)
def test_train_step_matches_one_process(worlds, mesh, arch):
    for t in (r["train"] for r in ranks(worlds, mesh, arch)):
        (l_s, l_1), (n_s, n_1) = t["loss"], t["grad_norm"]
        assert l_s == pytest.approx(l_1, rel=LOSS_RTOL)
        assert n_s == pytest.approx(n_1, rel=LOSS_RTOL)
        assert t["grad_rel"] <= GRAD_REL
        assert t["nu_rel"] <= GRAD_REL
        assert t["param_abs"] <= PARAM_ATOL
        assert t["step"] == 1
        assert t["struct_device"] == "meta"
        assert t["struct_dtype"] == "torch.bfloat16"
    if "mb2" in arch:
        assert t["microbatches"] == 2


@pytest.mark.parametrize("mesh,arch", CELLS, ids=IDS)
def test_sharded_leaves_hold_their_shard_alone(worlds, mesh, arch):
    for res in ranks(worlds, mesh, arch):
        assert res["train"]["sharded_leaves"] > 0
        faults = [f for step in res.values() for f in step["shard_faults"]]
        assert faults == []


@pytest.mark.parametrize("mesh,arch", CELLS, ids=IDS)
def test_no_dtensor_of_the_steps_is_strided(worlds, mesh, arch):
    """No DTensor that a step creates, an intermediate of a decomposed op
    included, has a ``_StridedShard`` placement: torch 2.13 makes one
    where a view merges a split dim into the dims before it, and torch
    2.11 (the card's machine) refuses that view."""
    for res in ranks(worlds, mesh, arch):
        assert {step: r["strided"] for step, r in res.items()
                if r["strided"]} == {}


@pytest.mark.parametrize("mesh,arch", CELLS, ids=IDS)
def test_resharding_restore_gives_the_same_step(worlds, mesh, arch):
    for r in ranks(worlds, mesh, arch):
        assert r["restore"]["param_abs"] == 0.0
        assert r["restore"]["loss"][0] == r["restore"]["loss"][1]


@pytest.mark.parametrize("mesh,arch", CELLS[:-1], ids=IDS[:-1])
def test_prefill_step_matches_one_process(worlds, mesh, arch):
    for p in (r["prefill"] for r in ranks(worlds, mesh, arch)):
        assert p["logits_abs"] <= LOGITS_ATOL
        assert p["cache_abs"] <= LOGITS_ATOL
        assert p["len_equal"]


@pytest.mark.parametrize("mesh,arch", CELLS[:-1], ids=IDS[:-1])
def test_serve_step_decodes_the_same_greedy_tokens(worlds, mesh, arch):
    for s in (r["serve"] for r in ranks(worlds, mesh, arch)):
        sharded, one = s["tokens"]
        assert sharded == one
        assert s["logits_abs"] <= LOGITS_ATOL
        assert s["cache_abs"] <= LOGITS_ATOL
