"""The port's training substrate on the CPU: the nine scenarios of
``tests/test_training.py`` on ``repro_torch.training``, then the port
against the JAX package on the same inputs: the token pipeline and the
int8 compression bitwise, one AdamW update, one ``make_train_step`` step
(microbatches 1 and 2, compression off and on) and three steps in a row
(params, every field of ``AdamWState`` and the metrics), checkpoints
crossing between the packages, and the serving ``forward`` building no
graph.  Tolerances are stated where they are used."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import TokenPipeline as JaxPipeline
from repro.training import adamw_update as jax_adamw_update
from repro.training import init_adamw as jax_init_adamw
from repro.training import make_train_step as jax_make_train_step
from repro.training.optimizer import compress_decompress as jax_cd
from repro.training.optimizer import quantize_int8 as jax_quantize
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import forward, forward_train, init_params
from repro_torch.training import (CheckpointManager, TokenPipeline,
                                  adamw_update, init_adamw, make_train_step)
from repro_torch.training.optimizer import (compress_decompress,
                                            quantize_int8)
from repro_torch.training.tree import leaves, tree_map

from _torch_port_util import jax_tree, perturbed_numpy_params

CFG = get_smoke("qwen1_5_0_5b")
JCFG = jax_smoke("qwen1_5_0_5b")


def fresh(seed: int):
    p = init_params(CFG, torch.Generator().manual_seed(seed), device="cpu")
    return p, init_adamw(p)


def as_torch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in
               zip(leaves(a), leaves(b)))


# --------------------------------------------------------------------------
# the nine scenarios of tests/test_training.py, on the port
# --------------------------------------------------------------------------

def test_loss_decreases():
    p, opt = fresh(0)
    step = make_train_step(CFG, remat=False, lr=3e-3)
    pipe = TokenPipeline(CFG.vocab, batch=4, seq=32, seed=0)
    losses = []
    for i in range(12):
        b = pipe.batch_at(i % 3)   # small cycling set => memorizable
        p, opt, m = step(p, opt, as_torch(b))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_grad_accum_equivalence():
    """microbatches=2 must match microbatches=1 on the same global batch
    (the reference's tolerances: loss rel 1e-5, params 1e-4)."""
    p, _ = fresh(1)
    pipe = TokenPipeline(CFG.vocab, batch=4, seq=16, seed=1)
    b = as_torch(pipe.batch_at(0))
    outs = {}
    for mb in (1, 2):
        step = make_train_step(CFG, remat=False, lr=1e-3, microbatches=mb)
        p2, _, m = step(p, init_adamw(p), b)
        outs[mb] = (float(m["loss"]), p2)
    assert outs[1][0] == pytest.approx(outs[2][0], rel=1e-5)
    assert max_abs(outs[1][1], outs[2][1]) < 1e-4


def test_compressed_grads_close_to_exact():
    g = torch.randn((256, 64), generator=torch.Generator().manual_seed(2)) \
        * 0.01
    q, s = quantize_int8(g)
    g2 = q.float() * s
    rel = float((g - g2).abs().max() / g.abs().max())
    assert rel < 0.02
    # error feedback keeps the accumulated bias bounded
    err = torch.zeros_like(g)
    acc_true, acc_hat = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(20):
        ghat, err = compress_decompress(g, err)
        acc_true += g
        acc_hat += ghat
    drift = float((acc_true - acc_hat).abs().max() / acc_true.abs().max())
    assert drift < 0.01


def test_train_step_with_compression_converges():
    p = init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    opt = init_adamw(p, compress=True)
    step = make_train_step(CFG, remat=False, lr=3e-3, compress_grads=True)
    pipe = TokenPipeline(CFG.vocab, batch=4, seq=32, seed=3)
    losses = []
    for i in range(10):
        p, opt, m = step(p, opt, as_torch(pipe.batch_at(i % 2)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_data_pipeline_deterministic_replay():
    a = TokenPipeline(1000, 4, 32, seed=7).batch_at(42)
    b = TokenPipeline(1000, 4, 32, seed=7).batch_at(42)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = TokenPipeline(1000, 4, 32, seed=8).batch_at(42)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_checkpoint_roundtrip_and_restart(tmp_path):
    p, opt = fresh(4)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, {"params": p, "opt": opt, "step": 10})
    mgr.save(20, {"params": p, "opt": opt, "step": 20})
    mgr.save(30, {"params": p, "opt": opt, "step": 30})
    assert mgr.latest_step() == 30
    # retention: only 2 newest kept
    assert not os.path.exists(os.path.join(str(tmp_path), "step_10"))
    restored, step = mgr.restore({"params": p, "opt": opt, "step": 0})
    assert step == 30 and int(restored["step"]) == 30
    for a, b in zip(leaves(restored["params"]), leaves(p)):
        assert torch.equal(a, b)


def test_checkpoint_corruption_detected(tmp_path):
    p = {"w": torch.ones((8, 8))}
    mgr = CheckpointManager(str(tmp_path))
    d = mgr.save(1, p)
    # corrupt the shard
    path = os.path.join(d, "shard_0.npz")
    data = dict(np.load(path))
    data["a0"] = data["a0"] + 1.0
    np.savez(path, **data)
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(p)


def test_checkpoint_async_save(tmp_path):
    p = {"w": torch.arange(64.0).reshape(8, 8)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, p)
    mgr.wait()
    restored, step = mgr.restore(p)
    assert step == 5
    assert torch.equal(restored["w"], p["w"])


def test_checkpoint_training_restart_equivalence(tmp_path):
    """Train 4 steps; or train 2, checkpoint, restart, train 2 more: the
    final params must agree at the reference's atol 1e-6."""
    step = make_train_step(CFG, remat=False, lr=1e-3)
    pipe = TokenPipeline(CFG.vocab, 2, 16, seed=9)

    p, opt = fresh(5)
    for i in range(4):
        p, opt, _ = step(p, opt, as_torch(pipe.batch_at(i)))

    p2, opt2 = fresh(5)
    mgr = CheckpointManager(str(tmp_path))
    for i in range(2):
        p2, opt2, _ = step(p2, opt2, as_torch(pipe.batch_at(i)))
    mgr.save(2, {"p": p2, "o": opt2})
    p3, opt3 = fresh(6)                 # fresh tensors to restore into
    restored, s = mgr.restore({"p": p3, "o": opt3})
    p3, opt3 = restored["p"], restored["o"]
    for i in range(2, 4):
        p3, opt3, _ = step(p3, opt3, as_torch(pipe.batch_at(i)))
    for a, b_ in zip(leaves(p), leaves(p3)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# the port against the JAX package
# --------------------------------------------------------------------------

def test_token_pipeline_is_bitwise_the_references():
    for vocab, batch, seq, seed, frames, d in ((256, 4, 32, 0, 0, 0),
                                               (151936, 8, 64, 3, 0, 0),
                                               (256, 2, 16, 1, 32, 64)):
        mine = TokenPipeline(vocab, batch, seq, seed=seed, enc_frames=frames,
                             d_model=d)
        ref = JaxPipeline(vocab, batch, seq, seed=seed, enc_frames=frames,
                          d_model=d)
        for i in (0, 5):
            a, b = mine.batch_at(i), ref.batch_at(i)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_int8_compression_is_bitwise_the_references():
    rng = np.random.default_rng(11)
    for shape, scale in (((256, 64), 0.01), ((7, 33), 3.0), ((5,), 1e-9)):
        g = (rng.standard_normal(shape) * scale).astype(np.float32)
        e = (rng.standard_normal(shape) * scale * 0.1).astype(np.float32)
        q, s = quantize_int8(torch.as_tensor(g))
        qj, sj = jax_quantize(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        assert q.dtype == torch.int8
        assert s.numpy().tobytes() == np.asarray(sj).tobytes()
        gh, ne = compress_decompress(torch.as_tensor(g), torch.as_tensor(e))
        ghj, nej = jax_cd(jnp.asarray(g), jnp.asarray(e))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(ghj))
        np.testing.assert_array_equal(ne.numpy(), np.asarray(nej))


def numpy_leaves(tree) -> list:
    """Either package's tree as numpy arrays, in ``jax.tree`` order."""
    return [np.asarray(x) for x in leaves(tree)]


def state_arrays(opt) -> dict:
    """An AdamWState (either package) as numpy arrays by field."""
    out = {"step": np.asarray(opt.step)}
    for f in ("mu", "nu", "master", "err"):
        tree = getattr(opt, f)
        out[f] = None if tree is None else numpy_leaves(tree)
    return out


# one step of AdamW from equal inputs: products, powers and square roots
# in fp32 in both packages; 2e-6 relative to each leaf's largest entry
STATE_REL = 2e-6


def assert_state_close(got, want, rel=STATE_REL, master_atol=None,
                       odd=0):
    """Every field of two AdamWStates: ``step`` equal; each leaf of
    ``mu`` / ``nu`` within ``rel`` of the leaf's largest entry, ``err``
    within ``rel`` of its gradient's, ``master`` within ``master_atol``
    (default: as the moments), all but ``odd`` entries per leaf."""
    a, b = state_arrays(got), state_arrays(want)
    assert int(a["step"]) == int(b["step"])
    for f in ("mu", "nu", "master", "err"):
        assert (a[f] is None) == (b[f] is None), f
        for x, y in zip(a[f] or [], b[f] or []):
            tol = rel * float(np.abs(y).max())
            if f == "err":
                # err = g_c - dequant(quant(g_c)) cancels: its error is the
                # gradient's, and |err| <= scale / 2 = max |g_c| / 254
                tol *= 254
            if f == "master" and master_atol is not None:
                tol = master_atol
            bad = int((np.abs(x - y) > tol).sum())
            assert bad <= odd, (f, bad, float(np.abs(x - y).max()), tol)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_the_reference(compress):
    tree = perturbed_numpy_params(JCFG, seed=0)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        tree)
    p_t = params_from_numpy(tree, device="cpu")
    g_t = params_from_numpy(grads, device="cpu")
    opt_t = init_adamw(p_t, compress=compress)
    opt_j = jax_init_adamw(jax_tree(tree), compress=compress)
    for _ in range(2):                  # the second step has err != 0
        p_t, opt_t = adamw_update(g_t, opt_t, p_t, lr=1e-3,
                                  compress=compress)
        p_j, opt_j = jax_adamw_update(jax_tree(grads), opt_j,
                                      jax_tree(tree), lr=1e-3,
                                      compress=compress)
        tree = jax.tree.map(np.asarray, p_j)
        p_t = params_from_numpy(tree, device="cpu")
    assert_state_close(opt_t, opt_j)


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


# One train step from equal weights and batch.  The loss and gradients
# agree to ~1e-6 (test_torch_train_parity.py); AdamW's first step moves
# each weight by ~lr * sign(g), so a gradient entry within rounding of 0
# may move the other way: params and ``master`` at 1e-4 absolute (the
# reference's grad-accumulation tolerance, lr 1e-3), the moments at 1e-4
# of each leaf's largest entry.  With compression an entry at a rounding
# boundary may land one int8 step away in the one package: at most one
# such entry per leaf (seen: one, in one leaf)
STEP_LR = 1e-3
PARAM_ATOL = 1e-4


@pytest.mark.parametrize("compress", [False, True],
                         ids=["exact", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(microbatches, compress):
    tree = perturbed_numpy_params(JCFG, seed=1)
    b = JaxPipeline(JCFG.vocab, 4, 16, seed=2).batch_at(0)
    step_j = jax.jit(jax_make_train_step(
        JCFG, remat=False, lr=STEP_LR, microbatches=microbatches,
        compress_grads=compress))
    p_j, o_j, m_j = step_j(jax_tree(tree),
                           jax_init_adamw(jax_tree(tree), compress=compress),
                           jax_batch(b))
    p_t = params_from_numpy(tree, device="cpu")
    step_t = make_train_step(CFG, remat=False, lr=STEP_LR,
                             microbatches=microbatches,
                             compress_grads=compress)
    p_t, o_t, m_t = step_t(p_t, init_adamw(p_t, compress=compress),
                           as_torch(b))
    assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]), rel=1e-5)
    assert float(m_t["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]),
                                                    rel=1e-5)
    assert max(float(np.abs(a.numpy() - np.asarray(b_)).max()) for a, b_ in
               zip(leaves(p_t), jax.tree.leaves(p_j))) < PARAM_ATOL
    assert_state_close(o_t, o_j, rel=1e-4, master_atol=PARAM_ATOL,
                       odd=1 if compress else 0)


def test_three_steps_match_the_reference():
    tree = perturbed_numpy_params(JCFG, seed=3)
    pipe = JaxPipeline(JCFG.vocab, 4, 16, seed=4)
    step_j = jax.jit(jax_make_train_step(JCFG, remat=False, lr=STEP_LR))
    step_t = make_train_step(CFG, remat=False, lr=STEP_LR)
    p_j = jax_tree(tree)
    o_j = jax_init_adamw(p_j)
    p_t = params_from_numpy(tree, device="cpu")
    o_t = init_adamw(p_t)
    for i in range(3):
        b = pipe.batch_at(i)
        p_j, o_j, m_j = step_j(p_j, o_j, jax_batch(b))
        p_t, o_t, m_t = step_t(p_t, o_t, as_torch(b))
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-5)
    assert max(float(np.abs(a.numpy() - np.asarray(b_)).max()) for a, b_ in
               zip(leaves(p_t), jax.tree.leaves(p_j))) < PARAM_ATOL
    assert_state_close(o_t, o_j, rel=1e-4, master_atol=PARAM_ATOL)


def both_trees(compress: bool):
    tree = perturbed_numpy_params(JCFG, seed=6)
    p_j = jax_tree(tree)
    p_t = params_from_numpy(tree, device="cpu")
    return ({"params": p_j, "opt": jax_init_adamw(p_j, compress=compress),
             "step": 7},
            {"params": p_t, "opt": init_adamw(p_t, compress=compress),
             "step": 7})


@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, compress):
    tree_j, tree_t = both_trees(compress)
    JaxCheckpointManager(str(tmp_path)).save(3, tree_j)
    restored, step = CheckpointManager(str(tmp_path)).restore(tree_t)
    assert step == 3 and isinstance(restored["opt"], type(tree_t["opt"]))
    got, want = numpy_leaves(restored), numpy_leaves(tree_j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, compress):
    tree_j, tree_t = both_trees(compress)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(4, tree_t)
    mgr.wait()
    restored, step = JaxCheckpointManager(str(tmp_path)).restore(tree_j)
    assert step == 4
    got, want = numpy_leaves(restored), numpy_leaves(tree_t)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_serving_forward_builds_no_graph():
    p = tree_map(lambda t: t.requires_grad_(True),
                 init_params(CFG, torch.Generator().manual_seed(8),
                             device="cpu"))
    toks = torch.randint(0, CFG.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(9))
    logits = forward(CFG, p, toks)
    assert not logits.requires_grad and logits.grad_fn is None
    assert forward_train(CFG, p, toks).grad_fn is not None


# --------------------------------------------------------------------------
# the launcher and the resume example, on the CPU
# --------------------------------------------------------------------------

def test_launcher_trains_and_resumes_from_its_checkpoint(tmp_path):
    from repro_torch.launch import train
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(args + ["--steps", "4"])
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert all(np.isfinite(first["losses"]))
    again = train.main(args + ["--steps", "6"])
    assert again["start"] == 4 and len(again["losses"]) == 2
    # the resumed run continues the first: one process, 6 steps
    whole = train.train(CFG, steps=6, batch=2, seq=16, lr=3e-3,
                        device="cpu", verbose=False)
    for a, b in zip(leaves(whole["params"]), leaves(again["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_train_resume_example_on_cpu():
    from repro_torch.examples import train_resume
    out = train_resume.main(["--steps", "44", "--device", "cpu"])
    assert out["crash_at"] == 22 and out["restored_at"] == 20
    assert len(out["losses"]) == 22 + 24
    assert out["losses"][-1] < out["losses"][0]
