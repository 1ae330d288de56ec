"""The plain PyTorch versions of the ported kernels against the JAX
package on the ``tests/test_kernels.py`` and ``tests/test_spec_decode.py``
sweeps: the Pallas kernels in interpret mode (``repro.kernels.ops``) and
the ``ref.py`` oracles, fp32 at 2e-5 and bf16 at 2e-2.  The port's
dispatch sends CPU tensors to these plain versions."""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def both(a, name):
    """One numpy array as a JAX and a torch array of the same dtype (bf16
    rounding done once, by torch, so both sides see the same values)."""
    t = torch.as_tensor(a).to(DTYPES[name][1])
    j = jnp.asarray(t.float().numpy()).astype(DTYPES[name][0])
    return j, t


def ints(a):
    return jnp.asarray(a, jnp.int32), torch.as_tensor(a, dtype=torch.int32)


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,hd,page,maxp", [
    (2, 4, 4, 32, 16, 4),      # MHA (G=1)
    (3, 8, 2, 64, 16, 5),      # GQA G=4
    (1, 16, 2, 16, 8, 8),      # G=8, small pages
    (4, 6, 6, 128, 32, 2),     # head_dim 128
    (2, 32, 2, 128, 16, 3),    # ChatGLM3-6B: G=16, head_dim 128
    (3, 8, 2, 8, 16, 4),       # head_dim 8 (the dense SMOKE configs)
])
def test_paged_decode_plain_matches_jax(dtype, b, h, hkv, hd, page, maxp):
    rng = np.random.default_rng(b * 100 + h)
    n_pages = maxp * b + 3
    q_j, q_t = both(rng.standard_normal((b, h, hd)), dtype)
    k_j, k_t = both(rng.standard_normal((n_pages, page, hkv, hd)), dtype)
    v_j, v_t = both(rng.standard_normal((n_pages, page, hkv, hd)), dtype)
    bt_j, bt_t = ints(rng.integers(0, n_pages, (b, maxp)))
    lens = rng.integers(1, maxp * page + 1, b)
    lens[0] = 1
    ln_j, ln_t = ints(lens)
    got = tops.paged_decode_attention(q_t, k_t, v_t, bt_t, ln_t)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, hd)
    for want in (jops.paged_decode_attention(q_j, k_j, v_j, bt_j, ln_j),
                 jref.paged_decode_attention_ref(q_j, k_j, v_j, bt_j, ln_j)):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,sq,smax,h,hkv,hd,kvb", [
    (2, 8, 64, 4, 2, 32, 16),
    (1, 16, 128, 8, 8, 16, 32),
    (3, 4, 40, 6, 2, 64, 16),   # smax not a multiple of kvb
    (2, 8, 64, 32, 2, 128, 16),  # ChatGLM3-6B: G=16, head_dim 128
    (2, 8, 48, 8, 2, 8, 16),    # head_dim 8
])
def test_packed_prefill_plain_matches_jax(dtype, s, sq, smax, h, hkv, hd,
                                          kvb):
    rng = np.random.default_rng(s * 10 + sq)
    q_j, q_t = both(rng.standard_normal((s, sq, h, hd)), dtype)
    k_j, k_t = both(rng.standard_normal((s, smax, hkv, hd)), dtype)
    v_j, v_t = both(rng.standard_normal((s, smax, hkv, hd)), dtype)
    lens = rng.integers(sq, smax + 1, s)
    lens[0] = sq                                  # fresh prompt, no prefix
    ctx_j, ctx_t = ints(lens - sq)
    got = tops.packed_prefill_attention(q_t, k_t, v_t, ctx_t)
    assert got.dtype == DTYPES[dtype][1] and got.shape == q_t.shape
    packed = jops.packed_prefill_attention(q_j, k_j, v_j, ctx_j,
                                           kv_block=kvb)
    per_request = jref.chunked_prefill_attention_ref(q_j, k_j, v_j,
                                                     ctx_j + sq)
    for want in (packed, per_request):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    # the per-request plain version is the packed one at ctx + Sq
    np.testing.assert_allclose(
        f32(tref.chunked_prefill_attention_ref(q_t, k_t, v_t, ctx_t + sq)),
        f32(got), atol=0, rtol=0)


CHUNKED_SWEEP = [      # tests/test_kernels.py::test_chunked_prefill_sweep
    (2, 8, 64, 4, 2, 32, 16),
    (1, 16, 128, 8, 8, 16, 32),
    (3, 4, 40, 6, 2, 64, 16),   # smax not a multiple of kvb
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,smax,h,hkv,hd,kvb", CHUNKED_SWEEP)
def test_chunked_prefill_plain_matches_jax(dtype, b, sq, smax, h, hkv, hd,
                                           kvb):
    rng = np.random.default_rng(b * 7 + sq)
    q_j, q_t = both(rng.standard_normal((b, sq, h, hd)), dtype)
    k_j, k_t = both(rng.standard_normal((b, smax, hkv, hd)), dtype)
    v_j, v_t = both(rng.standard_normal((b, smax, hkv, hd)), dtype)
    ln_j, ln_t = ints(rng.integers(sq, smax + 1, b))
    got = tops.chunked_prefill_attention(q_t, k_t, v_t, ln_t)
    assert got.dtype == DTYPES[dtype][1] and got.shape == q_t.shape
    for want in (jops.chunked_prefill_attention(q_j, k_j, v_j, ln_j,
                                                kv_block=kvb),
                 jref.chunked_prefill_attention_ref(q_j, k_j, v_j, ln_j)):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def test_chunked_prefill_plain_fresh_prompt():
    """cache_len == Sq: a prompt with no prefix, causal within the chunk
    (``tests/test_kernels.py::test_chunked_prefill_fresh_prompt``)."""
    b, sq, h, hkv, hd = 2, 12, 4, 2, 16
    rng = np.random.default_rng(12)
    q_j, q_t = both(rng.standard_normal((b, sq, h, hd)), "float32")
    k_j, k_t = both(rng.standard_normal((b, sq, hkv, hd)), "float32")
    v_j, v_t = both(rng.standard_normal((b, sq, hkv, hd)), "float32")
    ln_j, ln_t = ints(np.full(b, sq))
    got = tops.chunked_prefill_attention(q_t, k_t, v_t, ln_t)
    want = jops.chunked_prefill_attention(q_j, k_j, v_j, ln_j, kv_block=8)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    # row 0 sees only key 0: its output is v[0] exactly up to rounding
    np.testing.assert_allclose(got[:, 0].numpy(),
                               v_t[:, 0].repeat_interleave(h // hkv, 1)
                               .numpy(), atol=1e-6)


def test_chunked_plain_is_packed_plain_per_segment_bitwise():
    """The JAX contract of the two prefill kernels: per segment, packed
    equals one chunked call at ``cache_lens = ctx_lens + Sq``, bit for
    bit (each segment computed alone against the pack)."""
    rng = np.random.default_rng(4)
    s, sq, smax, h, hkv, hd = 3, 16, 64, 8, 2, 32
    q = torch.as_tensor(rng.standard_normal((s, sq, h, hd)),
                        dtype=torch.float32)
    kc = torch.as_tensor(rng.standard_normal((s, smax, hkv, hd)),
                         dtype=torch.float32)
    vc = torch.as_tensor(rng.standard_normal((s, smax, hkv, hd)),
                         dtype=torch.float32)
    ctx = torch.tensor([0, 33, 48], dtype=torch.int32)
    packed = tops.packed_prefill_attention(q, kc, vc, ctx)
    for i in range(s):
        one = tops.chunked_prefill_attention(q[i:i + 1], kc[i:i + 1],
                                             vc[i:i + 1], ctx[i:i + 1] + sq)
        assert torch.equal(one[0], packed[i])


def verify_case(rng, n_seg, depth, page, hkv, g, hd, n_pages, maxp, base):
    """``tests/test_spec_decode.py::test_packed_verify_kernel_contract``'s
    layout: rows (seg, j), j = 0..depth, per-row length l_kv + j + 1."""
    tables = rng.permutation(np.arange(1, n_pages))[:n_seg * maxp]
    tables = tables.reshape(n_seg, maxp).astype(np.int32)
    row_seg = np.repeat(np.arange(n_seg, dtype=np.int32), depth + 1)
    lengths = np.concatenate(
        [b + np.arange(depth + 1, dtype=np.int32) + 1 for b in base])
    q = rng.standard_normal((len(row_seg), hkv * g, hd))
    kp = rng.standard_normal((n_pages, page, hkv, hd))
    vp = rng.standard_normal((n_pages, page, hkv, hd))
    return q, kp, vp, tables, lengths.astype(np.int32), row_seg


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_seg,depth,page,hkv,g,hd,n_pages,maxp,base", [
    (3, 2, 8, 2, 4, 16, 24, 3, [9, 14, 20]),        # test_spec_decode.py
    (4, 1, 16, 4, 1, 64, 20, 4, [0, 15, 16, 47]),   # MHA, block edges
    (2, 3, 16, 2, 7, 128, 12, 5, [60, 3]),          # Qwen2-7B's G = 7
    (2, 2, 16, 2, 16, 128, 12, 4, [20, 40]),        # ChatGLM3-6B's G = 16
    (3, 2, 8, 2, 4, 8, 24, 3, [9, 14, 20]),         # head_dim 8
])
def test_packed_verify_plain_matches_jax(dtype, n_seg, depth, page, hkv, g,
                                         hd, n_pages, maxp, base):
    rng = np.random.default_rng(n_seg * 10 + depth)
    q, kp, vp, tables, lengths, row_seg = verify_case(
        rng, n_seg, depth, page, hkv, g, hd, n_pages, maxp, base)
    q_j, q_t = both(q, dtype)
    k_j, k_t = both(kp, dtype)
    v_j, v_t = both(vp, dtype)
    bt_j, bt_t = ints(tables)
    ln_j, ln_t = ints(lengths)
    rs_j, rs_t = ints(row_seg)
    got = tops.packed_verify_attention(q_t, k_t, v_t, bt_t, ln_t, rs_t)
    assert got.dtype == DTYPES[dtype][1] and got.shape == q_t.shape
    for want in (jops.packed_verify_attention(q_j, k_j, v_j, bt_j, ln_j,
                                              rs_j),
                 jref.packed_verify_attention_ref(q_j, k_j, v_j, bt_j, ln_j,
                                                  rs_j)):
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    # each verify row is the decode row on its gathered table, bitwise
    gathered = tops.paged_decode_attention(q_t, k_t, v_t,
                                           bt_t[rs_t.long()].contiguous(),
                                           ln_t)
    assert torch.equal(got, gathered)


def test_decode_plain_is_the_dense_decode_attention():
    """Paged plain version == the model's dense decode attention on the
    same logical KV (the engine relies on this)."""
    from repro.models.layers import decode_attention
    rng = np.random.default_rng(5)
    b, h, hkv, hd, page, maxp = 2, 4, 2, 16, 8, 4
    n_pages = b * maxp + 1
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    bt = np.arange(1, 1 + b * maxp, dtype=np.int32).reshape(b, maxp)
    lens = np.array([13, 29], np.int32)
    got = tops.paged_decode_attention(*map(torch.as_tensor,
                                           (q, kp, vp, bt, lens)))
    k_lin = kp[bt].reshape(b, maxp * page, hkv, hd)
    v_lin = vp[bt].reshape(b, maxp * page, hkv, hd)
    want = decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k_lin),
                            jnp.asarray(v_lin), jnp.asarray(lens))[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_cpu_tensors_never_launch_a_kernel():
    from repro_torch.kernels.paged_attention import paged_decode_attention
    tops.reset_launch_counts()
    args = [torch.zeros(1, 2, 16), torch.zeros(3, 8, 2, 16),
            torch.zeros(3, 8, 2, 16), torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32)]
    tops.paged_decode_attention(*args)
    blocks = torch.ones(1, 2, 2, 4, 1, 8)
    tops.kv_block_dequantize(*tops.kv_block_quantize(blocks))
    tops.block_gather(torch.zeros(3, 8, 2, 16), torch.tensor([2, 0]))
    tops.packed_verify_attention(*args[:3], args[3], args[4],
                                 torch.zeros(1, dtype=torch.int32))
    tops.chunked_prefill_attention(torch.zeros(1, 4, 2, 16),
                                   torch.zeros(1, 8, 2, 16),
                                   torch.zeros(1, 8, 2, 16),
                                   torch.full((1,), 4, dtype=torch.int32))
    assert tops.launch_counts() == {
        "paged_decode_attention": 0, "packed_prefill_attention": 0,
        "chunked_prefill_attention": 0, "packed_verify_attention": 0,
        "kv_block_quantize": 0, "kv_block_dequantize": 0, "block_gather": 0}
    # the CUDA wrapper itself refuses CPU tensors instead of falling back
    with pytest.raises(ValueError):
        paged_decode_attention(*args)
    with pytest.raises(ValueError):
        tops.paged_decode_attention(*[a.to("meta") for a in args])
    from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
    from repro_torch.kernels.spec_verify import packed_verify_attention
    with pytest.raises(ValueError):
        packed_verify_attention(*args, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        chunked_prefill_attention(torch.zeros(1, 4, 2, 16),
                                  torch.zeros(1, 8, 2, 16),
                                  torch.zeros(1, 8, 2, 16),
                                  torch.full((1,), 4, dtype=torch.int32))


def test_launch_counters_count_exactly_from_many_threads():
    """The engine thread and the transfer worker launch at once: every
    launch is counted (more threads than cores, a short switch
    interval)."""
    import os
    import sys
    import threading

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0

    def launch():
        for _ in range(5000):
            build.count_launch(wrapper)

    n = (os.cpu_count() or 1) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 5000 * n
    build.reset_launches([wrapper])
    assert wrapper.launches == 0


def test_first_build_runs_once_when_threads_race(monkeypatch):
    """Threads that reach the first launch together build the library
    once (stand-ins for nvcc and the loader: there is none here)."""
    import ctypes
    import threading
    import time

    from repro_torch.kernels import build

    builds = []

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build(verbose=False):
        builds.append(1)
        time.sleep(0.05)
        return ""

    monkeypatch.setattr(build, "is_current", lambda: False)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(
            build.library())) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len({id(lib) for lib in libs}) == 1
    finally:
        build._load.cache_clear()


def test_c_signatures_match_the_sources():
    """Every C entry point's ctypes argument list matches its declaration
    in ``csrc/`` in count and kind (pointer, int, float, long long): a
    mismatch would only show at the first launch on the card."""
    import ctypes
    import re

    from repro_torch.kernels import build

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float, "longlong": ctypes.c_longlong}
    src = "".join(p.read_text() for p in build.sources())
    declared = dict(re.findall(r'extern "C" int (\w+)\((.*?)\)', src, re.S))
    assert set(declared) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        got = []
        for arg in declared[name].split(","):
            words = arg.replace("const", "").split()
            kind = "".join(words[:-1]) + ("*" if "*" in arg else "")
            got.append(kinds["void*" if "*" in kind else kind])
        assert got == argtypes, name


# --------------------------------------------------------------------------
# The precision argument of the tensor-core prefill kernel (fp32 as 3xTF32),
# emulated in plain PyTorch: TF32 keeps 10 of fp32's 23 mantissa bits.
# --------------------------------------------------------------------------

def tf32_rna(x):
    """fp32 -> TF32, to nearest with ties away from zero (cvt.rna.tf32.f32;
    the kernel's two-instruction form), as fp32 values."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """fp32 -> TF32 by dropping the low 13 bits (what the tensor core reads
    of an unrounded operand)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tc_matmul(a, b, terms, step=8):
    """a @ b as mma.sync computes it: fp32 accumulators, one k-step of
    ``step`` at a time, each step's products of ``terms`` ((a part, b
    part) pairs of TF32 values) exact in fp64, added in order."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], step):
        for ta, tb in terms:
            part = ta(a[:, k0:k0 + step]).double() @ tb(b[k0:k0 + step]).double()
            acc = (acc.double() + part).float()
    return acc


def split_terms(small):
    """The 3xTF32 terms in the kernel's order: small*big, big*small,
    big*big; ``small`` rounds the residual x - big to TF32."""
    big = tf32_rna
    sm = lambda x: small(x - big(x))
    return [(sm, big), (big, sm), (big, big)]


def emulated_attention(q, k, v, q_pos, terms):
    """One head's causal attention with both products on emulated tensor
    cores and the softmax in fp32, as the kernel computes it."""
    s = tc_matmul(q, k.T, terms) / math.sqrt(q.shape[1])
    s = s.masked_fill(torch.arange(k.shape[0])[None] > q_pos[:, None],
                      -1e30)
    return tc_matmul(torch.softmax(s, dim=-1), v, terms)


def attention_head(hd, rows=16, keys=512, seed=0):
    """The last ``rows`` queries of a fresh ``keys``-token prompt (they see
    the most keys), standard-normal inputs as in ``chip_smoke.py``, and the
    fp64 result."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((rows, hd)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((keys, hd)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((keys, hd)), dtype=torch.float32)
    q_pos = torch.arange(keys - rows, keys)
    s = (q.double() @ k.double().T) / math.sqrt(hd)
    s = s.masked_fill(torch.arange(keys)[None] > q_pos[:, None], -math.inf)
    return q, k, v, q_pos, torch.softmax(s, dim=-1) @ v.double()


@pytest.mark.parametrize("small", [tf32_trunc, tf32_rna],
                         ids=["small_read_by_the_mma", "small_rounded"])
@pytest.mark.parametrize("hd", [64, 128], ids=["qwen1.5_hd64",
                                              "qwen2_hd128"])
def test_3xtf32_attention_holds_the_fp32_tolerance(hd, small):
    """fp32 attention with 3xTF32 products stays within the port's fp32
    tolerance (2e-5) of the fp64 result, with the residual either rounded
    or cut by the tensor core."""
    q, k, v, q_pos, want = attention_head(hd)
    got = emulated_attention(q, k, v, q_pos, split_terms(small))
    torch.testing.assert_close(got, want.float(), atol=2e-5, rtol=2e-5)
    assert float((got.double() - want).abs().max()) < 2e-6


@pytest.mark.parametrize("hd", [64, 128], ids=["qwen1.5_hd64",
                                              "qwen2_hd128"])
def test_1xtf32_attention_misses_the_fp32_tolerance(hd):
    """One TF32 product per product (what ``allow_tf32`` would give) is
    ~1e-4 off on these 16 rows: it cannot hold 2e-5, so the kernel never
    uses it for fp32."""
    q, k, v, q_pos, want = attention_head(hd)
    got = emulated_attention(q, k, v, q_pos, [(tf32_rna, tf32_rna)])
    err = float((got.double() - want).abs().max())
    assert err > 5e-5
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want.float(), atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------------------
# The schedule of the paged decode / verify kernel (csrc/paged_attention.cu),
# emulated in plain PyTorch: pages split over a cluster of blocks and their
# warps by page index, TP-position stages, per-split (m, l, acc) in log2
# units, and the fixed-order merge (warps in a block, then the blocks of the
# cluster).
# --------------------------------------------------------------------------

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def cu_constant(name, source="paged_attention.cu"):
    """A ``constexpr int`` of ``csrc/<source>``."""
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def stage_positions(hd, itemsize):
    """Positions per cp.async stage (``Cfg::TP``): ~STAGE_BYTES of K and V
    rows, clamped to 8..32."""
    return min(max(cu_constant("STAGE_BYTES") // (2 * hd * itemsize), 8),
               32)


def merge_states(states, g, hd):
    """(m, l, acc) states merged in list order, as the kernel merges the
    warps of a block and then the blocks of a cluster that have pages; no
    state gives (NEG_INF, 0, 0)."""
    if not states:
        return (torch.full((g,), NEG_INF, dtype=torch.float32),
                torch.zeros(g), torch.zeros(g, hd))
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = torch.maximum(mx, m)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l_, a in states:
        c = torch.exp2(m - mx)
        l_sum = l_sum + c * l_
        acc = acc + c[:, None] * a
    return mx, l_sum, acc


def split_decode(q, kp, vp, tables, lengths, row_seg=None, itemsize=4):
    """The kernel's schedule for every (row, kv head, head group of at
    most GROUP query heads): page i goes to block rank i % CLUSTER and
    warp (i // CLUSTER) % WARPS; each warp walks its pages in TP-position
    stages with an fp32 online softmax in log2 units (scores scaled, then
    masked); the warps with pages merge in order, then the ranks with
    pages."""
    cl, warps = cu_constant("CLUSTER"), cu_constant("WARPS")
    group = cu_constant("GROUP")
    rows, h, hd = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    g = h // hkv
    maxp = tables.shape[1]
    tp = stage_positions(hd, itemsize)
    scale2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    neg = torch.tensor(NEG_INF, dtype=torch.float32)
    out = torch.zeros(rows, h, hd, dtype=torch.float32)
    for b in range(rows):
        trow = tables[int(row_seg[b]) if row_seg is not None else b]
        ln = int(lengths[b])
        n_pages = min(-(-ln // page), maxp) if ln > 0 else 0
        for kvh, h0 in itertools.product(range(hkv), range(0, g, group)):
            heads = slice(kvh * g + h0, kvh * g + min(g, h0 + group))
            qg = q[b, heads].float()
            gl = qg.shape[0]
            blocks = []
            for rank in range(cl):
                states = []
                for w in range(warps):
                    m = torch.full((gl,), NEG_INF, dtype=torch.float32)
                    l_ = torch.zeros(gl)
                    acc = torch.zeros(gl, hd)
                    for i in range(w * cl + rank, n_pages, cl * warps):
                        for j0 in range(0, page, tp):
                            pos0 = i * page + j0
                            if pos0 >= ln:
                                break
                            rows_ = slice(j0, min(j0 + tp, page))
                            k = kp[int(trow[i]), rows_, kvh].float()
                            v = vp[int(trow[i]), rows_, kvh].float()
                            valid = pos0 + torch.arange(k.shape[0]) < ln
                            s = torch.where(valid, (qg @ k.T) * scale2, neg)
                            m_new = torch.maximum(m, s.max(dim=1).values)
                            alpha = torch.exp2(m - m_new)
                            p = torch.where(valid, torch.exp2(
                                s - m_new[:, None]), torch.zeros(()))
                            l_ = l_ * alpha + p.sum(dim=1)
                            acc = acc * alpha[:, None] + p @ v
                            m = m_new
                    if w * cl + rank < n_pages:
                        states.append((m, l_, acc))
                if rank < n_pages:
                    blocks.append(merge_states(states, gl, hd))
            _, l_sum, acc = merge_states(blocks, gl, hd)
            out[b, heads] = acc / torch.clamp(l_sum, min=1e-30)[:, None]
    return out.to(q.dtype)


def split_lengths(page, tp, maxp):
    """0, 1, a stage's and a page's edges, the edges of the cluster's
    ranks (CLUSTER pages) and of the whole split (CLUSTER * WARPS pages),
    each +- 1, and the full table."""
    splits = cu_constant("CLUSTER") * cu_constant("WARPS")
    edges = [tp, page, 2 * page, cu_constant("CLUSTER") * page,
             splits * page]
    lens = {0, 1, maxp * page}
    for e in edges:
        lens |= {e - 1, e, e + 1}
    return sorted(n for n in lens if 0 <= n <= maxp * page)


@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("hd", [64, 128, 8])
@pytest.mark.parametrize("g", [1, 7, 8, 16])
def test_decode_split_schedule_matches_plain(g, hd, page):
    """The emulated split/merge schedule equals the plain version at fp32
    2e-5 at every split edge, G 16 in two head groups of 8 included; a
    length-0 row writes 0 (every split empty), where the plain version's
    softmax over masked scores is not defined."""
    hkv = 2
    maxp = cu_constant("CLUSTER") * cu_constant("WARPS") + 3
    lens = split_lengths(page, stage_positions(hd, 4), maxp)
    rng = np.random.default_rng(g * 1000 + hd + page)
    b, n_pages = len(lens), len(lens) * maxp + 1
    q = torch.as_tensor(rng.standard_normal((b, g * hkv, hd)),
                        dtype=torch.float32)
    kp = torch.as_tensor(rng.standard_normal((n_pages, page, hkv, hd)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((n_pages, page, hkv, hd)),
                         dtype=torch.float32)
    bt = torch.as_tensor(1 + rng.permutation(n_pages - 1).reshape(b, maxp),
                         dtype=torch.int32)
    ln = torch.as_tensor(lens, dtype=torch.int32)
    got = split_decode(q, kp, vp, bt, ln)
    want = tref.paged_decode_attention_ref(q, kp, vp, bt, ln)
    live = ln > 0
    torch.testing.assert_close(got[live], want[live], atol=2e-5, rtol=2e-5)
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32_stages",
                                                  "bf16_stages"])
@pytest.mark.parametrize("base", [[15, 63, 255], [0, 62, 254]],
                         ids=["rows_cross_split_edges", "first_rows_empty"])
def test_decode_split_verify_row_is_decode_row_bitwise(base, itemsize):
    """A verify row runs the decode schedule on table row row_seg[b]: its
    emulated result is bitwise the decode row's on tables[row_seg], and
    the rows of one request that cross a rank or split edge (lengths
    l_kv + 1 .. l_kv + 3 around 64 and 256 at page 16) match the plain
    version."""
    depth, page, hkv, g, hd = 2, 16, 2, 4, 64
    rng = np.random.default_rng(sum(base) + itemsize)
    maxp = 20
    q, kp, vp, tables, lengths, row_seg = verify_case(
        rng, len(base), depth, page, hkv, g, hd, len(base) * maxp + 1, maxp,
        base)
    q, kp, vp = (torch.as_tensor(a, dtype=torch.float32) for a in (q, kp, vp))
    tables, lengths, row_seg = (torch.as_tensor(a) for a in
                                (tables, lengths, row_seg))
    got = split_decode(q, kp, vp, tables, lengths, row_seg, itemsize)
    dec = split_decode(q, kp, vp, tables[row_seg.long()], lengths,
                       itemsize=itemsize)
    assert torch.equal(got, dec)
    want = tref.packed_verify_attention_ref(q, kp, vp, tables, lengths,
                                            row_seg)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------------------
# The schedule of the int8 quantize kernel (csrc/kv_quant.cu), emulated in
# plain PyTorch: each plane row in slices, slice s to block rank s % C of a
# cluster, each rank's absmax over its slices, the ranks' maxima merged.
# --------------------------------------------------------------------------

def split_quantize(blocks, c, slice_values):
    """``kv_block_quantize`` on the cluster schedule: rank r of ``c``
    reduces the absmax of slices r, r + c, ... of ``slice_values`` values
    (0 where it has none), the ranks' maxima are merged in rank order, and
    scale, inverse and values follow from the merged max with the kernel's
    expressions (the fp32 constant 1/127, an IEEE 1 / scale, round half to
    even)."""
    n, lyr, two = blocks.shape[:3]
    x = blocks.reshape(n * lyr * two, -1).float()
    n_slices = -(-x.shape[1] // slice_values)
    amax = torch.zeros(x.shape[0])
    for rank in range(c):
        m = torch.zeros(x.shape[0])
        for sl in range(rank, n_slices, c):
            part = x[:, sl * slice_values:(sl + 1) * slice_values]
            m = torch.maximum(m, part.abs().amax(dim=1))
        amax = torch.maximum(amax, m)
    scale = amax * torch.tensor(np.float32(1.0 / 127.0))
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros(()))
    vals = torch.clamp(torch.round(x * inv[:, None]), -127, 127)
    return (vals.to(torch.int8).reshape(blocks.shape),
            scale.reshape(n, lyr, two))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plane", [(16, 2, 128), (16, 16, 64), (1, 1, 4102)],
                         ids=["E4096_glm", "E16384_qwen1.5", "E4102"])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_quantize_split_schedule_is_the_plain_version_bitwise(c, plane,
                                                              dtype):
    """The emulated cluster schedule of ``kv_block_quantize`` is bitwise
    ``kv_block_quantize_ref`` for clusters of 1-8 blocks, with the kernel's
    slice (THREADS x NV 16-byte vectors of this dtype) and with slices of
    about E / 2C values (two or more slices per rank, a partial last one),
    on rows with a zero plane and one of exact half steps."""
    rng = np.random.default_rng(c)
    x = torch.as_tensor(rng.standard_normal((2, 3, 2, *plane)) * 3,
                        dtype=torch.float32)
    x[0, 0, 1] = 0.0                                     # a zero plane
    e = int(np.prod(plane))
    half = torch.arange(e, dtype=torch.float32) % 254 - 126.5
    half[0] = 127.0                                      # scale 1
    x[-1, -1, 0] = half.reshape(plane)                   # half steps
    x = x.to(dtype)
    per_vector = 16 // x.element_size()
    kernel_slice = (cu_constant("THREADS", "kv_quant.cu")
                    * cu_constant("NV", "kv_quant.cu") * per_vector)
    want_v, want_s = tref.kv_block_quantize_ref(x)
    for slice_values in (kernel_slice, -(-e // (2 * c))):
        vals, scales = split_quantize(x, c, slice_values)
        assert torch.equal(vals, want_v) and torch.equal(scales, want_s)
