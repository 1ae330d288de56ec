"""The port's layers and dense forward against ``repro.models`` on the
same numpy inputs and perturbed parameters, fp32, atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_smoke
from repro.models import forward as jax_forward
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import forward, init_params

from _torch_port_util import jax_tree, perturbed_numpy_params

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(11)


def both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(kw or TOL))


def randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def test_norms():
    x, s, b = randn(3, 5, 32), randn(32), randn(32)
    close(TL.rmsnorm(*map(torch.as_tensor, (x, s))),
          JL.rmsnorm(*map(jnp.asarray, (x, s))))
    close(TL.layernorm(*map(torch.as_tensor, (x, s, b))),
          JL.layernorm(*map(jnp.asarray, (x, s, b))))
    p = {"scale": s, "bias": b}
    close(TL.apply_norm(torch.as_tensor(x),
                        {k: torch.as_tensor(v) for k, v in p.items()},
                        "layernorm"),
          JL.apply_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()},
                        "layernorm"))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    x = randn(2, 7, 4, 16)
    pos = (np.arange(7)[None] + np.array([[0], [33]])).astype(np.int32)
    close(TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), fraction),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction))
    inv_t, rot_t = TL.rope_frequencies(16, fraction)
    inv_j, rot_j = JL.rope_frequencies(16, fraction)
    assert rot_t == rot_j
    close(inv_t, inv_j)


def test_mlps():
    x = randn(2, 3, 16)
    sw = {"w_gate": randn(16, 24), "w_up": randn(16, 24),
          "w_down": randn(24, 16)}
    ge = {"w_up": randn(16, 24), "b_up": randn(24), "w_down": randn(24, 16),
          "b_down": randn(16)}
    for fn_t, fn_j, p in ((TL.swiglu, JL.swiglu, sw),
                          (TL.gelu_mlp, JL.gelu_mlp, ge)):
        close(fn_t(torch.as_tensor(x),
                   {k: torch.as_tensor(v) for k, v in p.items()}),
              fn_j(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}),
              atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("h,hkv,window", [(4, 4, 0), (8, 2, 0), (4, 2, 5)])
def test_dense_attention(h, hkv, window):
    q, k, v = randn(2, 9, h, 16), randn(2, 9, hkv, 16), randn(2, 9, hkv, 16)
    kv_len = np.array([9, 4], np.int32)
    for kw in (dict(causal=True, window=window),
               dict(causal=False, kv_len=kv_len)):
        tkw = {k_: torch.as_tensor(v_) if isinstance(v_, np.ndarray) else v_
               for k_, v_ in kw.items()}
        jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_
               for k_, v_ in kw.items()}
        close(TL.dense_attention(*map(torch.as_tensor, (q, k, v)), **tkw),
              JL.dense_attention(*map(jnp.asarray, (q, k, v)), **jkw))


# the dense configs whose SMOKE variants have head_dim 8
HD8_DENSE = ["chameleon_34b", "chatglm3_6b", "deepseek_coder_33b",
             "phi4_mini_3_8b", "qwen3_32b"]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_7b"] + HD8_DENSE)
def test_forward_logits_match_jax(arch):
    cfg = get_smoke(arch)
    tree = perturbed_numpy_params(cfg)
    tokens = RNG.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    want, _ = jax_forward(cfg, jax_tree(tree), jnp.asarray(tokens))
    tcfg = t_get_smoke(arch)
    params = params_from_numpy(tree, device="cpu")
    got = forward(tcfg, params, torch.as_tensor(tokens))
    close(got, want)
    close(forward(tcfg, params, torch.as_tensor(tokens), last_only=True),
          np.asarray(want)[:, -1:])


def test_params_bridge_round_trips():
    cfg = get_smoke("qwen2_7b")
    tree = perturbed_numpy_params(cfg)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    same(tree, back)


def test_init_params_has_the_reference_layout():
    cfg = get_smoke("qwen1_5_0_5b")
    ref = perturbed_numpy_params(cfg)
    got = params_to_numpy(init_params(t_get_smoke("qwen1_5_0_5b"),
                                      torch.Generator().manual_seed(0),
                                      device="cpu"))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else v.shape
                for k, v in t.items()}
    assert shapes(got) == shapes(ref)
    assert (got["layers"]["attn"]["bq"] == 0).all()
    assert (got["layers"]["ln1"]["scale"] == 1).all()
    # the reference's scales: N(0, 1/fan_in) matrices, 0.02 embeddings
    assert abs(got["layers"]["mlp"]["w_up"].std() * np.sqrt(cfg.d_model)
               - 1.0) < 0.1
    assert abs(got["embed"].std() / 0.02 - 1.0) < 0.1


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_1_3b",
                                  "whisper_small"])
def test_other_families_are_not_ported(arch):
    with pytest.raises(NotImplementedError):
        init_params(t_get_smoke(arch), torch.Generator(), device="cpu")
