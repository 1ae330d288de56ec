"""``decode_step``, ``decode_batch``, ``verify_step``, ``prefill_packed``
and ``prefill_chunk`` of the port against the JAX package's
``serving.model_exec`` on the same pool, tables and inputs: equal argmax
tokens, logits and the updated pool allclose at 1e-5 — including the
padding rows, whose writes land in the null block 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.serving import model_exec as jexec
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import model_exec as texec

from _torch_port_util import jax_tree, perturbed_numpy_params

BS = 16
NUM_BLOCKS = 24
# Qwen1.5-0.5B and Qwen2-7B, then the dense configs whose SMOKE variants
# have head_dim 8
ARCHS = ["qwen1_5_0_5b", "qwen2_7b", "chameleon_34b", "chatglm3_6b",
         "deepseek_coder_33b", "phi4_mini_3_8b", "qwen3_32b"]


def setup(arch, seed):
    cfg = get_smoke(arch)
    tree = perturbed_numpy_params(cfg, seed)
    rng = np.random.default_rng(seed)
    pool = (0.5 * rng.standard_normal(
        (cfg.n_layers, 2, NUM_BLOCKS, BS, cfg.n_kv_heads, cfg.hd))
    ).astype(np.float32)
    return (cfg, t_get_smoke(arch), jax_tree(tree),
            params_from_numpy(tree, device="cpu"), pool, rng)


def assert_pools_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    cfg, tcfg, jparams, tparams, pool, rng = setup(arch, 1)
    # three live requests padded to seg_bucket(3) = 4 rows; the pad row
    # (token 0, length 0, zero table) writes the null block 0
    tables_l = [[3, 7, 1], [5], [2, 9, 11, 4]]
    lens_l = [40, 9, 50]
    b = texec.seg_bucket(len(lens_l))
    maxp = texec.table_bucket(max(map(len, tables_l)))
    tables = np.zeros((b, maxp), np.int32)
    for i, t in enumerate(tables_l):
        tables[i, :len(t)] = t
    lens = np.zeros(b, np.int32)
    lens[:3] = lens_l
    tokens = np.zeros(b, np.int32)
    tokens[:3] = rng.integers(1, cfg.vocab, 3)
    want_tok, want_pool = jexec.decode_step(
        cfg, jparams, jnp.asarray(pool), jnp.asarray(tokens),
        jnp.asarray(tables), jnp.asarray(lens))
    t_pool = torch.as_tensor(pool.copy())
    got_tok, got_pool = texec.decode_step(
        tcfg, tparams, t_pool, *map(torch.as_tensor, (tokens, tables, lens)))
    assert got_pool is t_pool                    # updated in place
    assert got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy()[:3],
                                  np.asarray(want_tok)[:3])
    assert_pools_close(got_pool, want_pool)
    assert not np.allclose(t_pool[:, :, 0, 0].numpy(), pool[:, :, 0, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_batch_matches_jax(arch):
    """The logits decode (the engine's ``fused_decode=False`` path): the
    exact batch, no padding, (B, V) logits."""
    cfg, tcfg, jparams, tparams, pool, rng = setup(arch, 3)
    tables = np.array([[3, 7, 1, 0], [5, 0, 0, 0], [2, 9, 11, 4]], np.int32)
    lens = np.array([40, 9, 50], np.int32)
    tokens = rng.integers(1, cfg.vocab, 3).astype(np.int32)
    want_logits, want_pool = jexec.decode_batch(
        cfg, jparams, jnp.asarray(pool), jnp.asarray(tokens),
        jnp.asarray(tables), jnp.asarray(lens))
    t_pool = torch.as_tensor(pool.copy())
    got_logits, got_pool = texec.decode_batch(
        tcfg, tparams, t_pool, *map(torch.as_tensor, (tokens, tables, lens)))
    assert got_pool is t_pool and got_logits.shape == (3, cfg.vocab)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    assert_pools_close(got_pool, want_pool)


def verify_inputs(cfg, rng, segs):
    """The arrays ``Engine._run_decode_spec`` builds for requests of
    (table, l_kv, depth): one row per (request, draft position), tables
    compact and padded with an all-zero row that the padding rows use."""
    n_seg = len(segs)
    n_rows = sum(1 + d for _, _, d in segs)
    r_b = texec.seg_bucket(n_rows)
    s_b = texec.seg_bucket(n_seg + 1)
    maxp = texec.table_bucket(max(len(t) for t, _, _ in segs))
    tokens = np.zeros(r_b, np.int32)
    lens = np.zeros(r_b, np.int32)
    row_seg = np.full(r_b, n_seg, np.int32)
    tables = np.zeros((s_b, maxp), np.int32)
    ri = 0
    for i, (t, l_kv, d) in enumerate(segs):
        tables[i, :len(t)] = t
        for j in range(d + 1):
            tokens[ri] = rng.integers(1, cfg.vocab)
            lens[ri] = l_kv + j
            row_seg[ri] = i
            ri += 1
    return tokens, tables, lens, row_seg, n_rows


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_jax(arch):
    cfg, tcfg, jparams, tparams, pool, rng = setup(arch, 4)
    # depths 2, 0, 1 (one request runs plain), a block edge crossed by the
    # second draft position of the first; 6 rows padded to 8, 3 segments
    # to seg_bucket(4) = 4 table rows
    segs = [([3, 7, 1], 31, 2), ([5], 9, 0), ([2, 9, 11, 4], 50, 1)]
    tokens, tables, lens, row_seg, n_rows = verify_inputs(cfg, rng, segs)
    want_tok, want_pool = jexec.verify_step(
        cfg, jparams, jnp.asarray(pool), jnp.asarray(tokens),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(row_seg))
    t_pool = torch.as_tensor(pool.copy())
    got_tok, got_pool = texec.verify_step(
        tcfg, tparams, t_pool,
        *map(torch.as_tensor, (tokens, tables, lens, row_seg)))
    assert got_pool is t_pool and got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy()[:n_rows],
                                  np.asarray(want_tok)[:n_rows])
    assert_pools_close(got_pool, want_pool)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ctx,n,table", [
    (0, 20, [6, 2]),            # a fresh prompt: 20 tokens padded to 32
    (37, 9, [8, 2, 13]),        # a chunk after 37 cached tokens
])
def test_prefill_chunk_matches_jax(arch, ctx, n, table):
    """One request's chunk: the (1, c, V) logits of the real rows and the
    pool, the padding's writes through the request's table included.
    The null block 0 (where padding past the table's blocks lands, more
    than once per slot) is left out of the comparison."""
    cfg, tcfg, jparams, tparams, pool, rng = setup(arch, 5)
    c = texec.bucket(n)
    span = texec.staging_span(ctx, c, 64, BS)
    assert span == 64               # the reference's max_ctx there too
    toks = np.zeros((1, c), np.int32)
    toks[0, :n] = rng.integers(1, cfg.vocab, n)
    tab = np.zeros((1, span // BS), np.int32)
    tab[0, :len(table)] = table
    ctx_a = np.array([ctx], np.int32)
    want_logits, want_pool = jexec.prefill_chunk(
        cfg, jparams, jnp.asarray(pool), jnp.asarray(toks),
        jnp.asarray(tab), jnp.asarray(ctx_a), span)
    t_pool = torch.as_tensor(pool.copy())
    got_logits, got_pool = texec.prefill_chunk(
        tcfg, tparams, t_pool, *map(torch.as_tensor, (toks, tab, ctx_a)),
        span)
    assert got_pool is t_pool and got_logits.shape == (1, c, cfg.vocab)
    np.testing.assert_allclose(got_logits.numpy()[0, :n],
                               np.asarray(want_logits)[0, :n], atol=1e-5,
                               rtol=1e-5)
    assert int(got_logits[0, n - 1].argmax()) == int(
        jnp.argmax(want_logits[0, n - 1]))
    assert_pools_close(got_pool[:, :, 1:], np.asarray(want_pool)[:, :, 1:])


def test_staging_span_rounds_only_where_the_reference_cannot_reshape():
    for ctx, c in [(0, 16), (100, 512), (500, 512), (0, 1024)]:
        assert texec.staging_span(ctx, c, 1024, 16) == 1024
    assert texec.staging_span(16, 1024, 1024, 16) == 1040
    assert texec.staging_span(1, 1024, 1024, 16) == 1040   # ref: 1025


def packed_inputs(cfg, rng, segs):
    """The arrays ``Engine._run_prefill_packed`` builds for segments of
    (table, ctx, n_tokens): flat stream, scatter targets, staging tables."""
    n_seg = len(segs)
    sq = texec.chunk_bucket(max(n for _, _, n in segs))
    smax = texec.chunk_bucket(max(c + n for _, c, n in segs))
    smax = -(-smax // BS) * BS
    maxp = smax // BS
    total = sum(n for _, _, n in segs)
    t_b = texec.flat_bucket(total)
    s_b = texec.seg_bucket(n_seg)
    tokens = np.zeros((1, t_b), np.int32)
    positions = np.zeros((1, t_b), np.int32)
    q_rows = np.full((t_b,), s_b, np.int32)
    q_cols = np.zeros((t_b,), np.int32)
    sblocks = np.zeros((t_b,), np.int32)
    sslots = np.zeros((t_b,), np.int32)
    tables = np.zeros((s_b, maxp), np.int32)
    ctx_lens = np.zeros((s_b,), np.int32)
    last_idx = np.zeros((s_b,), np.int32)
    off = 0
    for i, (t, ctx, n) in enumerate(segs):
        t = np.asarray(t, np.int32)
        tokens[0, off:off + n] = rng.integers(1, cfg.vocab, n)
        pos = np.arange(ctx, ctx + n, dtype=np.int32)
        positions[0, off:off + n] = pos
        q_rows[off:off + n] = i
        q_cols[off:off + n] = np.arange(n, dtype=np.int32)
        sblocks[off:off + n] = t[pos // BS]
        sslots[off:off + n] = pos % BS
        k = min(len(t), maxp)
        tables[i, :k] = t[:k]
        ctx_lens[i] = ctx
        last_idx[i] = off + n - 1
        off += n
    arrays = (tokens, positions, q_rows, q_cols, sblocks, sslots, tables,
              ctx_lens, last_idx)
    return arrays, smax, sq


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_packed_matches_jax(arch):
    cfg, tcfg, jparams, tparams, pool, rng = setup(arch, 2)
    # a fresh prompt, a chunk after a cached prefix, and a short tail
    # chunk: 3 segments padded to 4, flat stream padded past 61 tokens
    segs = [([1, 6], 0, 20), ([8, 2, 13], 32, 14), ([4, 10, 15], 20, 27)]
    arrays, smax, sq = packed_inputs(cfg, rng, segs)
    want_logits, want_pool = jexec.prefill_packed(
        cfg, jparams, jnp.asarray(pool), *map(jnp.asarray, arrays), smax,
        sq)
    t_pool = torch.as_tensor(pool.copy())
    got_logits, got_pool = texec.prefill_packed(
        tcfg, tparams, t_pool, *map(torch.as_tensor, arrays), smax, sq)
    assert got_pool is t_pool
    np.testing.assert_array_equal(
        got_logits.argmax(-1).numpy()[:3],
        np.asarray(jnp.argmax(want_logits, -1))[:3])
    np.testing.assert_allclose(got_logits.numpy()[:3],
                               np.asarray(want_logits)[:3], atol=1e-5,
                               rtol=1e-5)
    assert_pools_close(got_pool, want_pool)


def test_buckets_are_the_reference_buckets():
    for n in list(range(1, 300)) + [511, 512, 513, 2047, 2049, 3000, 5000]:
        assert texec.bucket(n) == jexec.bucket(n)
        assert texec.flat_bucket(n) == jexec.flat_bucket(n)
        assert texec.chunk_bucket(n) == jexec.chunk_bucket(n)
        assert texec.table_bucket(n) == jexec.table_bucket(n)
        assert texec.seg_bucket(n) == jexec.seg_bucket(n)
