"""The port's training loss and gradients against the JAX package's.

Each SMOKE config of the five families (dense, MoE, SSM, hybrid,
enc-dec) on one batch of the reference's ``TokenPipeline``, with weights
from ``perturbed_numpy_params``: the port's ``value_and_grad`` of
``make_loss_fn`` against ``jax.value_and_grad`` of the reference's,
with the dense and the chunked attention.  Tolerances: loss rel 1e-5;
for each gradient leaf, max |g_port - g_jax| <= 1e-4 x max |g_jax| (a
leaf the loss does not read is exactly zero in both).  Then ``remat``:
the port's gradients with per-layer recomputation are bitwise those
without it on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.training import TokenPipeline as JaxPipeline
from repro.training import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.train import make_loss_fn, value_and_grad
from repro_torch.training.tree import leaves

from _torch_port_util import jax_tree, perturbed_numpy_params

ARCHS = ["qwen1_5_0_5b", "olmoe_1b_7b", "mamba2_1_3b", "hymba_1_5b",
         "whisper_small"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def batch_for(cfg, batch=2, seq=24, seed=3) -> dict:
    return JaxPipeline(cfg.vocab, batch, seq, seed=seed,
                       enc_frames=cfg.enc_frames,
                       d_model=cfg.d_model).batch_at(0)


def jax_loss_and_grads(cfg, tree, b, attn_impl, remat=False):
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(
        cfg, attn_impl=attn_impl, remat=remat)))
    loss, grads = fn(jax_tree(tree), jnp.asarray(b["tokens"]),
                     jnp.asarray(b["labels"]),
                     None if "enc_inputs" not in b
                     else jnp.asarray(b["enc_inputs"]))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_loss_and_grads(cfg, tree, b, attn_impl, remat=False):
    params = params_from_numpy(tree, device="cpu")
    enc = (torch.as_tensor(b["enc_inputs"]) if "enc_inputs" in b
           else None)
    loss, grads = value_and_grad(make_loss_fn(
        cfg, attn_impl=attn_impl, remat=remat))(
        params, torch.as_tensor(b["tokens"]), torch.as_tensor(b["labels"]),
        enc)
    return float(loss), [g.numpy() for g in leaves(grads)]


def assert_grads_close(got: list, want: list, finite_only=False):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if finite_only:
            ok = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), ok)
            g, w = g[ok], w[ok]
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= GRAD_REL * scale, (i, err, scale)


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, attn_impl):
    cfg_j, cfg_t = jax_smoke(arch), get_smoke(arch)
    tree = perturbed_numpy_params(cfg_j, seed=1)
    b = batch_for(cfg_j)
    loss_j, g_j = jax_loss_and_grads(cfg_j, tree, b, attn_impl)
    loss_t, g_t = port_loss_and_grads(cfg_t, tree, b, attn_impl)
    assert np.isfinite(loss_t)
    assert loss_t == pytest.approx(loss_j, rel=LOSS_RTOL)
    assert all(np.isfinite(g).all() for g in g_t)
    assert_grads_close(g_t, g_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise_without_remat(arch):
    cfg = get_smoke(arch)
    tree = perturbed_numpy_params(jax_smoke(arch), seed=2)
    b = batch_for(cfg)
    loss_a, g_a = port_loss_and_grads(cfg, tree, b, "dense", remat=False)
    loss_b, g_b = port_loss_and_grads(cfg, tree, b, "dense", remat=True)
    assert loss_a == loss_b
    for x, y in zip(g_a, g_b):
        np.testing.assert_array_equal(x, y)


def test_ssd_gradient_over_a_long_chunk_is_the_references():
    """A chunk longer than ~100 tokens overflows ``_segsum_decay``'s
    exp(diff) in the masked upper triangle: the forward stays finite (the
    ``where`` drops those entries) but the backward multiplies a zero
    cotangent by inf.  The reference does the same; the port keeps its
    gradient, NaNs included, entry for entry."""
    cfg_j = dataclasses.replace(jax_smoke("mamba2_1_3b"), ssm_chunk=256)
    cfg_t = dataclasses.replace(get_smoke("mamba2_1_3b"), ssm_chunk=256)
    tree = perturbed_numpy_params(cfg_j, seed=4)
    b = batch_for(cfg_j, batch=1, seq=240)
    loss_j, g_j = jax_loss_and_grads(cfg_j, tree, b, "dense")
    loss_t, g_t = port_loss_and_grads(cfg_t, tree, b, "dense")
    assert np.isfinite(loss_t)
    assert loss_t == pytest.approx(loss_j, rel=LOSS_RTOL)
    # the reference's behaviour at this length (ROADMAP Queue 3)
    assert not all(np.isfinite(g).all() for g in g_j)
    assert_grads_close(g_t, g_j, finite_only=True)


def test_ssd_short_chunks_keep_the_long_sequence_gradient_finite():
    """The same 240 tokens in chunks of 32 (chunking is exact): the
    masked exponents stay small, so both packages' gradients are finite
    and agree, at the tolerances above."""
    cfg_j = dataclasses.replace(jax_smoke("mamba2_1_3b"), ssm_chunk=32)
    cfg_t = dataclasses.replace(get_smoke("mamba2_1_3b"), ssm_chunk=32)
    tree = perturbed_numpy_params(cfg_j, seed=4)
    b = batch_for(cfg_j, batch=1, seq=240)
    loss_j, g_j = jax_loss_and_grads(cfg_j, tree, b, "dense")
    loss_t, g_t = port_loss_and_grads(cfg_t, tree, b, "dense")
    assert all(np.isfinite(g).all() for g in g_j)
    assert loss_t == pytest.approx(loss_j, rel=LOSS_RTOL)
    assert_grads_close(g_t, g_j)
