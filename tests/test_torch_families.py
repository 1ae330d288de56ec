"""Every model family of the port (dense, MoE, SSM, hybrid, enc-dec)
against the JAX package on the CPU, on the same numpy parameters
(perturbed biases, norm scales and SSM constants) and inputs, fp32:

* ``forward`` logits of all twelve SMOKE configs (atol = rtol = 1e-5;
  the enc-dec configs through the stub encoder frames);
* ``prefill`` + ``decode_step`` against teacher-forced ``forward``, the
  reference's contract (atol 2e-4, as ``test_models.py``), and each
  step's logits against the JAX ``prefill`` / ``decode_step`` (1e-5),
  the hybrid's ring cache past its window;
* the components ``test_models.py`` checks: chunked attention against
  dense (three shapes and the window), the SSD chunked scan against the
  stepwise recurrence and its prefix continuation, each also against
  the JAX function on the same arrays; ``decode_attention``, the
  sinusoidal positions and the KV cache updates against JAX;
* ``params_from_numpy`` keeping the SSM leaves fp32 in a bf16 tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.kvcache as JKV
import repro.models.layers as JL
import repro.models.ssm as JS
from repro.configs import ARCH_IDS, get_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.models import kvcache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import decode_step, forward, prefill

from _torch_port_util import jax_tree, perturbed_numpy_params

TOL = dict(atol=1e-5, rtol=1e-5)       # the port against JAX, fp32
TEACHER_ATOL = 2e-4                    # decode vs forward (test_models.py)
SSD_ATOL = 3e-4                        # chunked vs stepwise (test_models.py)
KEY = jax.random.PRNGKey(0)


def close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(kw or TOL))


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def setup(name, seed=0):
    cfg, tcfg = get_smoke(name), t_get_smoke(name)
    tree = perturbed_numpy_params(cfg)
    rng = np.random.default_rng(seed)
    kw_j, kw_t = {}, {}
    if cfg.family == "encdec":
        enc = randn(rng, 2, cfg.enc_frames, cfg.d_model, scale=0.02)
        kw_j["enc_inputs"], kw_t["enc_inputs"] = (jnp.asarray(enc),
                                                  torch.as_tensor(enc))
    return cfg, tcfg, tree, rng, kw_j, kw_t


@pytest.mark.parametrize("name", ARCH_IDS)
def test_forward_matches_jax(name):
    """``test_arch_smoke_forward_and_train_shapes``, the forward half: the
    logits' shape and finiteness, and equality with the JAX forward."""
    cfg, tcfg, tree, rng, kw_j, kw_t = setup(name)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want, _ = jax_forward(cfg, jax_tree(tree), jnp.asarray(toks), **kw_j)
    got = forward(tcfg, params_from_numpy(tree, device="cpu"),
                  torch.as_tensor(toks), **kw_t)
    assert got.shape == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(got).all())
    close(got, want)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_decode_matches_teacher_forcing(name):
    """prefill + decode_step reproduce the full-forward logits (the cache /
    rope / ring / state bookkeeping contract), and each step equals the
    JAX prefill / decode_step on the same cache history."""
    cfg, tcfg, tree, rng, kw_j, kw_t = setup(name, seed=1)
    B, S, extra = 2, 12, 3
    toks = rng.integers(0, cfg.vocab, (B, S + extra)).astype(np.int32)
    jp, tp = jax_tree(tree), params_from_numpy(tree, device="cpu")
    tt = torch.as_tensor(toks)
    full = forward(tcfg, tp, tt, **kw_t)
    lg, cache = prefill(tcfg, tp, tt[:, :S], max_seq=S + extra + 2, **kw_t)
    jlg, jcache = jax_prefill(cfg, jp, jnp.asarray(toks[:, :S]),
                              max_seq=S + extra + 2, **kw_j)
    close(lg, full[:, S - 1], atol=TEACHER_ATOL, rtol=0)
    close(lg, jlg)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
    for i in range(extra):
        lg, cache = decode_step(tcfg, tp, cache, tt[:, S + i])
        jlg, jcache = jax_decode_step(cfg, jp, jcache,
                                      jnp.asarray(toks[:, S + i]))
        close(lg, full[:, S + i], atol=TEACHER_ATOL, rtol=0)
        close(lg, jlg)
    close(cache["len"], jcache["len"])


def test_hybrid_ring_cache_past_the_window():
    """Hymba's sliding window (16 in SMOKE) with a prompt longer than it:
    prefill keeps the trailing window in ring slots, decode overwrites
    them; logits equal teacher-forced forward and JAX."""
    cfg, tcfg, tree, rng, _, _ = setup("hymba_1_5b", seed=2)
    assert cfg.window == 16
    S, extra = 21, 14                      # decode wraps the ring again
    toks = rng.integers(0, cfg.vocab, (2, S + extra)).astype(np.int32)
    jp, tp = jax_tree(tree), params_from_numpy(tree, device="cpu")
    tt = torch.as_tensor(toks)
    full = forward(tcfg, tp, tt)
    lg, cache = prefill(tcfg, tp, tt[:, :S], max_seq=S + extra)
    jlg, jcache = jax_prefill(cfg, jp, jnp.asarray(toks[:, :S]),
                              max_seq=S + extra)
    assert cache["k"].shape[2] == cfg.window
    close(cache["k"], jcache["k"])
    close(lg, full[:, S - 1], atol=TEACHER_ATOL, rtol=0)
    for i in range(extra):
        lg, cache = decode_step(tcfg, tp, cache, tt[:, S + i])
        jlg, jcache = jax_decode_step(cfg, jp, jcache,
                                      jnp.asarray(toks[:, S + i]))
        close(lg, full[:, S + i], atol=TEACHER_ATOL, rtol=0)
        close(lg, jlg)
    close(cache["ssm"], jcache["ssm"])


@pytest.mark.parametrize("name", ["qwen2_7b", "whisper_small",
                                  "hymba_1_5b"])
def test_chunked_forward_matches_jax(name):
    """``forward(attn_impl="chunked")`` against the JAX chunked path."""
    cfg, tcfg, tree, rng, kw_j, kw_t = setup(name, seed=3)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    want, _ = jax_forward(cfg, jax_tree(tree), jnp.asarray(toks),
                          attn_impl="chunked", **kw_j)
    got = forward(tcfg, params_from_numpy(tree, device="cpu"),
                  torch.as_tensor(toks), attn_impl="chunked", **kw_t)
    close(got, want)


# --- components -------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,h,hkv,chunk", [
    (8, 32, 4, 2, 8), (16, 16, 4, 4, 16), (5, 40, 6, 2, 7),
])
def test_chunked_attention_matches_dense(sq, skv, h, hkv, chunk):
    rng = np.random.default_rng(4)
    q = randn(rng, 2, sq, h, 16)
    k, v = randn(rng, 2, skv, hkv, 16), randn(rng, 2, skv, hkv, 16)
    off = skv - sq
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    d = TL.dense_attention(tq, tk, tv, causal=True, q_offset=off)
    c = TL.chunked_attention(tq, tk, tv, causal=True, q_offset=off,
                             kv_chunk=chunk)
    close(d, c, atol=2e-5, rtol=0)
    close(c, JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_offset=off,
                                  kv_chunk=chunk))


def test_chunked_attention_window():
    rng = np.random.default_rng(5)
    q, k, v = (randn(rng, 1, 24, 2, 8) for _ in range(3))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    d = TL.dense_attention(tq, tk, tv, causal=True, window=6)
    c = TL.chunked_attention(tq, tk, tv, causal=True, window=6, kv_chunk=8)
    close(d, c, atol=2e-5, rtol=0)
    close(c, JL.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  window=6, kv_chunk=8))


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(6)
    q = randn(rng, 3, 1, 8, 16)
    kc, vc = randn(rng, 3, 20, 2, 16), randn(rng, 3, 20, 2, 16)
    lens = np.array([20, 7, 1], np.int32)
    got = TL.decode_attention(*map(torch.as_tensor, (q, kc, vc, lens)),
                              window=window)
    want = JL.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                               window=window)
    close(got, want)


def test_sinusoidal_positions_and_cache_updates_match_jax():
    close(TL.sinusoidal_positions(37, 24), JL.sinusoidal_positions(37, 24))
    rng = np.random.default_rng(7)
    kc, vc = randn(rng, 2, 10, 2, 4), randn(rng, 2, 10, 2, 4)
    kn, vn = randn(rng, 2, 3, 2, 4), randn(rng, 2, 3, 2, 4)
    lens = np.array([0, 6], np.int32)
    for t_fn, j_fn, extra in (
            (TKV.update_layer_cache, JKV.update_layer_cache, ()),
            (TKV.update_ring_cache, JKV.update_ring_cache, (4,))):
        got = t_fn(*map(torch.tensor, (kc, vc, kn, vn, lens)), *extra)
        want = j_fn(*map(jnp.asarray, (kc, vc, kn, vn, lens)), *extra)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c = TKV.init_attn_cache(2, 3, 8, 2, 4)
    jc = JKV.init_attn_cache(2, 3, 8, 2, 4)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert c["k"].dtype == torch.bfloat16 and c["len"].dtype == torch.int32


def ssm_pair(spec):
    jp = JS.init_ssm(KEY, spec)
    tree = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(8)
    for k in ("A_log", "dt_bias", "conv_b"):
        tree[k] = tree[k] + randn(rng, *tree[k].shape, scale=0.3)
    return jax_tree(tree), params_from_numpy(tree, device="cpu")


def test_ssd_chunked_equals_stepwise():
    """The SSD chunked scan equals the token-by-token recurrence (the
    state-space duality itself); both equal JAX."""
    spec = TS.spec_for(d_model=32, d_state=16, head_dim=8, chunk=8)
    jp, tp = ssm_pair(spec)
    x = randn(np.random.default_rng(9), 2, 20, 32, scale=0.5)
    y_chunk, final = TS.ssd_chunked(tp, spec, torch.as_tensor(x))
    st = TS.init_state(spec, 2)
    ys = []
    for t in range(20):
        y_t, st = TS.ssd_decode_step(tp, spec, torch.as_tensor(x[:, t:t + 1]),
                                     st)
        ys.append(y_t)
    y_step = torch.cat(ys, dim=1)
    close(y_chunk, y_step, atol=SSD_ATOL, rtol=0)
    close(final.ssm, st.ssm, atol=SSD_ATOL, rtol=0)
    jy, jfinal = JS.ssd_chunked(jp, spec, jnp.asarray(x))
    close(y_chunk, jy)
    close(final.ssm, jfinal.ssm)
    close(final.conv, jfinal.conv)
    jst = JS.init_state(spec, 2)
    for t in range(20):
        jy_t, jst = JS.ssd_decode_step(jp, spec, jnp.asarray(x[:, t:t + 1]),
                                       jst)
    close(ys[-1], jy_t)
    close(st.ssm, jst.ssm)


def test_ssd_prefix_continuation():
    """Chunked prefix + stepwise continuation == full stepwise run."""
    spec = TS.spec_for(d_model=16, d_state=8, head_dim=8, chunk=4)
    jp, tp = ssm_pair(spec)
    x = torch.as_tensor(randn(np.random.default_rng(10), 1, 12, 16,
                              scale=0.5))
    _, mid = TS.ssd_chunked(tp, spec, x[:, :8])
    y_a, _ = TS.ssd_decode_step(tp, spec, x[:, 8:9], mid)
    st = TS.init_state(spec, 1)
    for t in range(9):
        y_b, st = TS.ssd_decode_step(tp, spec, x[:, t:t + 1], st)
    close(y_a, y_b, atol=SSD_ATOL, rtol=0)
    _, jmid = JS.ssd_chunked(jp, spec, jnp.asarray(x[:, :8].numpy()))
    jy_a, _ = JS.ssd_decode_step(jp, spec, jnp.asarray(x[:, 8:9].numpy()),
                                 jmid)
    close(y_a, jy_a)


def test_bf16_ssm_tree_keeps_the_reference_leaf_dtypes():
    """A bf16 mamba2 tree converts as the reference builds it: the SSM's
    ``A_log``, ``D`` and ``dt_bias`` in fp32, every other leaf bf16 with
    the same bits; the port's own bf16 ``init_params`` agrees."""
    cfg = get_smoke("mamba2_1_3b")
    jtree = jax_init_params(cfg, KEY, dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jtree)
    got = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    from repro_torch.models.model import init_params
    own = init_params(t_get_smoke("mamba2_1_3b"),
                      torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16, device="cpu")

    def visit(t, g, o, path=()):
        assert t.keys() == g.keys() == o.keys()
        for k in t:
            if isinstance(t[k], dict):
                visit(t[k], g[k], o[k], path + (k,))
                continue
            want = torch.float32 if k in TS.FP32_LEAVES else torch.bfloat16
            assert t[k].dtype.name == ("float32" if want == torch.float32
                                       else "bfloat16"), path + (k,)
            assert g[k].dtype == o[k].dtype == want, path + (k,)
            np.testing.assert_array_equal(
                g[k].float().numpy(), np.asarray(t[k], np.float32))
    visit(tree, got, own)
    # the bf16 tree runs: SSD state and decay arithmetic stay fp32
    toks = torch.randint(0, cfg.vocab, (1, 9),
                         generator=torch.Generator().manual_seed(1))
    lg, cache = prefill(t_get_smoke("mamba2_1_3b"), got, toks, max_seq=9)
    assert lg.dtype == torch.bfloat16 and cache["ssm"].dtype == torch.float32
    assert bool(torch.isfinite(lg.float()).all())


def test_encdec_needs_encoder_frames_and_caches_hold_the_prompt():
    tcfg = t_get_smoke("whisper_small")
    tp = params_from_numpy(perturbed_numpy_params(
        get_smoke("whisper_small")), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_inputs"):
        forward(tcfg, tp, toks)
    # torch's pad would crop a cache shorter than the prompt silently
    with pytest.raises(ValueError, match="max_seq"):
        prefill(t_get_smoke("qwen2_7b"), params_from_numpy(
            perturbed_numpy_params(get_smoke("qwen2_7b")), device="cpu"),
            toks, max_seq=3)
