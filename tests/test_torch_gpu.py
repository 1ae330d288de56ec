"""CUDA kernels of the PyTorch port against their plain versions, on the
card.  Run there with ``python -m pytest -m gpu tests/test_torch_gpu.py``;
without a card every test skips (decided inside the ``cuda`` fixture, so
all workers collect the same tests).  Imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_gather import block_gather
from repro_torch.kernels.chunked_prefill import (chunked_prefill_attention,
                                                 packed_prefill_attention)
from repro_torch.kernels.kv_quant import kv_block_dequantize, kv_block_quantize
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.spec_verify import packed_verify_attention

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


def decode_inputs(dev, dtype, b, h, hkv, hd, page, maxp, lens, seed=0):
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + 3
    q = torch.as_tensor(rng.standard_normal((b, h, hd)), dtype=dtype)
    kp = torch.as_tensor(rng.standard_normal((n_pages, page, hkv, hd)),
                         dtype=dtype)
    vp = torch.as_tensor(rng.standard_normal((n_pages, page, hkv, hd)),
                         dtype=dtype)
    bt = torch.as_tensor(rng.permutation(n_pages)[:b * maxp]
                         .reshape(b, maxp), dtype=torch.int32)
    ln = torch.as_tensor(lens, dtype=torch.int32)
    return [t.to(dev) for t in (q, kp, vp, bt, ln)]


def prefill_inputs(dev, dtype, s, sq, smax, h, hkv, hd, ctx, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((s, sq, h, hd)), dtype=dtype)
    kc = torch.as_tensor(rng.standard_normal((s, smax, hkv, hd)), dtype=dtype)
    vc = torch.as_tensor(rng.standard_normal((s, smax, hkv, hd)), dtype=dtype)
    cl = torch.as_tensor(ctx, dtype=torch.int32)
    return [t.to(dev) for t in (q, kc, vc, cl)]


def named(cases: list, extra: dict) -> dict:
    """parametrize() arguments: ``cases`` under their ids so far (case0,
    case1, ...), then ``extra`` under its keys."""
    return dict(argvalues=cases + list(extra.values()),
                ids=[f"case{i}" for i in range(len(cases))] + list(extra))


DECODE_CASES = [
    # b, h, hkv, hd, page, maxp, lens
    (16, 16, 16, 64, 16, 12, [1, 16, 17, 191, 192, 100, 5, 33,
                              64, 65, 2, 150, 180, 8, 120, 77]),   # qwen1.5
    (5, 28, 4, 128, 16, 9, [1, 144, 70, 16, 99]),                  # qwen2-7b
    (3, 4, 2, 16, 8, 5, [1, 40, 23]),                              # smoke
    (2, 8, 1, 32, 32, 3, [96, 31]),                                # G=8
    # the cluster split's edges (page i -> rank i % 4, warp (i // 4) % 4):
    # lengths +- 1 around a page, 4 pages (the ranks) and 16 pages (every
    # split once), a length-0 row, and the 64-page table of max_ctx 1024
    (16, 16, 16, 64, 16, 64, [0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257,
                              511, 512, 513, 1023, 1024]),
    # Qwen2-7B's G 7 at hd 128 (8-position fp32 stages) past 600 positions
    (4, 28, 4, 128, 16, 48, [601, 640, 700, 768]),
    # page 8 (a stage holds one page) and page 32 (two or four stages)
    (11, 8, 2, 64, 8, 40, [0, 7, 8, 9, 31, 32, 33, 127, 128, 129, 320]),
    (15, 8, 2, 128, 32, 20, [0, 1, 7, 8, 9, 31, 32, 33, 127, 128, 129, 511,
                             512, 513, 640]),
    # page 12: a page is not a whole number of 8-position stages
    (6, 4, 4, 64, 12, 20, [1, 8, 12, 13, 100, 240]),
]
# G > 8 runs in head groups of 8; head_dim 8 (the dense SMOKE configs)
DECODE_NEW = {
    "glm_g16_hd128": (16, 32, 2, 128, 16, 48,
                      [0, 1, 15, 16, 17, 64, 65, 127, 128, 129, 255, 256,
                       257, 511, 767, 768]),           # ChatGLM3-6B widths
    "g12_hd64": (5, 24, 2, 64, 16, 12, [1, 40, 100, 150, 192]),   # 8 + 4
    "hd8": (16, 8, 2, 8, 16, 64, [0, 1, 15, 16, 17, 31, 32, 33, 63, 64,
                                  65, 255, 256, 257, 512, 1024]),
    "hd8_mha_page8": (4, 4, 4, 8, 8, 10, [1, 33, 64, 80]),
}
DECODE = named(DECODE_CASES, DECODE_NEW)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **DECODE)
def test_paged_decode_matches_plain(cuda, dtype, case):
    b, h, hkv, hd, page, maxp, lens = case
    args = decode_inputs(cuda, dtype, b, h, hkv, hd, page, maxp, lens)
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(*args)
    # a length-0 row sees no key: 0, as in the TPU kernel (the plain
    # version's softmax over all-masked scores is not defined there)
    live = args[4] > 0
    torch.testing.assert_close(out[live].float(), want[live].float(),
                               **tol(dtype))
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **DECODE)
def test_paged_decode_row_does_not_depend_on_the_batch(cuda, dtype, case):
    """The split points depend on a row's length only and the merge order
    is fixed: each row launched alone gives the bits it has in the batch."""
    b, h, hkv, hd, page, maxp, lens = case
    q, kp, vp, bt, ln = decode_inputs(cuda, dtype, b, h, hkv, hd, page, maxp,
                                      lens)
    out = paged_decode_attention(q, kp, vp, bt, ln)
    for i in range(b):
        one = paged_decode_attention(q[i:i + 1], kp, vp, bt[i:i + 1],
                                     ln[i:i + 1])
        torch.cuda.synchronize()
        assert torch.equal(one[0], out[i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_glm_head_group_does_not_change_a_heads_bits(cuda, dtype):
    """At G 16 (two head groups of 8 per kv head) a query head gives the
    same bits in either group: swapping the groups' queries swaps the
    output's heads, bitwise."""
    b, h, hkv, hd, page, maxp, lens = DECODE_NEW["glm_g16_hd128"]
    q, kp, vp, bt, ln = decode_inputs(cuda, dtype, b, h, hkv, hd, page, maxp,
                                      lens)
    g = h // hkv
    perm = torch.arange(h).reshape(hkv, 2, g // 2).flip(1).reshape(-1)
    perm = perm.to(cuda)
    out = paged_decode_attention(q, kp, vp, bt, ln)
    swapped = paged_decode_attention(q[:, perm].contiguous(), kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(swapped, out[:, perm])


PREFILL_CASES = [
    # s, sq, smax, h, hkv, hd, ctx
    (4, 128, 512, 16, 16, 64, [0, 384, 100, 17]),                  # qwen1.5
    (3, 64, 192, 28, 4, 128, [0, 128, 61]),                        # qwen2-7b
    (2, 16, 48, 4, 2, 16, [0, 32]),                                # smoke
    (2, 40, 64, 6, 2, 32, [24, 3]),                                # ragged
    # the tensor-core tiling's edges: Sq not a multiple of 16 or 64, a
    # 16-row MMA tile straddling two query heads (G = 7, Sq = 40), hd 16 /
    # 32 / 128, Smax not a multiple of the key tile, a chunk ending at Smax,
    # Sq = 1024 against a 1024 span
    (2, 100, 256, 8, 2, 64, [0, 156]),                  # Sq 100, ends at Smax
    (2, 40, 128, 28, 4, 128, [0, 88]),                  # G 7, Sq 40, hd 128
    (2, 40, 96, 14, 2, 64, [10, 56]),                   # G 7, Smax 96
    (3, 40, 100, 4, 1, 16, [0, 60, 30]),                # hd 16, Smax 100
    (2, 100, 300, 6, 3, 32, [0, 200]),                  # hd 32, Smax 300
    (2, 64, 150, 4, 4, 128, [0, 86]),                   # hd 128, Smax 150
    (1, 1024, 1024, 16, 16, 64, [0]),                   # the max_ctx bucket
]
PREFILL_NEW = {
    "glm_hd128": (4, 256, 512, 32, 2, 128, [0, 256, 100, 64]),    # G 16
    "hd8": (3, 64, 192, 8, 2, 8, [0, 128, 61]),
    "hd8_sq100_g2": (2, 100, 256, 6, 3, 8, [0, 156]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **named(PREFILL_CASES, PREFILL_NEW))
def test_packed_prefill_matches_plain(cuda, dtype, case):
    s, sq, smax, h, hkv, hd, ctx = case
    args = prefill_inputs(cuda, dtype, s, sq, smax, h, hkv, hd, ctx)
    out = packed_prefill_attention(*args)
    torch.cuda.synchronize()
    want = ref.packed_prefill_attention_ref(*args)
    # rows whose position runs past the staged cache are padding the
    # engine discards; compare the rows a real chunk can have
    for i, c in enumerate(ctx):
        n = min(sq, smax - c)
        torch.testing.assert_close(out[i, :n].float(), want[i, :n].float(),
                                   **tol(dtype))


CHUNKED_CASES = [
    # b, sq, smax, h, hkv, hd, cache_lens
    (1, 512, 1024, 16, 16, 64, [512]),                  # qwen1.5 ingest
    (1, 16, 1024, 16, 16, 64, [320]),                   # qwen1.5 tail chunk
    (3, 64, 192, 28, 4, 128, [64, 192, 125]),           # qwen2-7b
    (2, 40, 64, 6, 2, 32, [64, 43]),                    # ragged
    (2, 100, 256, 8, 2, 64, [100, 256]),                # Sq 100, ends at Smax
    (2, 40, 100, 28, 4, 16, [40, 100]),                 # G 7, Sq 40, hd 16
    (2, 40, 72, 14, 2, 32, [72, 55]),                   # hd 32, Smax 72
    (2, 64, 160, 28, 4, 128, [160, 90]),                # G 7, hd 128
    (1, 1024, 1024, 16, 16, 64, [1024]),                # the max_ctx bucket
]
CHUNKED_NEW = {
    "glm_hd128": (2, 64, 192, 32, 2, 128, [64, 150]),
    "hd8": (2, 40, 100, 8, 2, 8, [40, 100]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **named(CHUNKED_CASES, CHUNKED_NEW))
def test_chunked_prefill_matches_plain(cuda, dtype, case):
    b, sq, smax, h, hkv, hd, lens = case
    args = prefill_inputs(cuda, dtype, b, sq, smax, h, hkv, hd, lens)
    out = chunked_prefill_attention(*args)
    torch.cuda.synchronize()
    want = ref.chunked_prefill_attention_ref(*args)
    torch.testing.assert_close(out.float(), want.float(), **tol(dtype))


def test_chunked_prefill_rows_before_position_zero_are_zero(cuda):
    """cache_lens < Sq puts the first rows at negative positions: they
    see no key and are 0, as in the TPU kernel (the plain version, a
    softmax over all-masked scores, is not defined there); the rest
    match the plain version."""
    q, kc, vc, _ = prefill_inputs(cuda, torch.float32, 2, 32, 64, 4, 2, 16,
                                  [0, 0])
    lens = torch.tensor([20, 32], dtype=torch.int32, device=cuda)
    out = chunked_prefill_attention(q, kc, vc, lens)
    want = ref.chunked_prefill_attention_ref(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert torch.equal(out[0, :12], torch.zeros_like(out[0, :12]))
    torch.testing.assert_close(out[0, 12:], want[0, 12:], **tol(torch.float32))
    torch.testing.assert_close(out[1], want[1], **tol(torch.float32))


# rows before position 0 (cache_lens < Sq): b, sq, smax, h, hkv, hd,
# cache_lens
NEGATIVE_CASES = [
    (2, 100, 256, 8, 2, 64, [37, 100]),
    (2, 40, 128, 28, 4, 128, [9, 40]),
]
NEGATIVE_NEW = {"hd8": (2, 40, 128, 8, 2, 8, [9, 40])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **named(NEGATIVE_CASES, NEGATIVE_NEW))
def test_chunked_prefill_rows_before_position_zero_at_the_tiling_edges(
        cuda, dtype, case):
    """As above, at widths where a 16-row MMA tile holds rows on both
    sides of position 0 (Sq 100, and G 7 with Sq 40)."""
    b, sq, smax, h, hkv, hd, lens = case
    args = prefill_inputs(cuda, dtype, b, sq, smax, h, hkv, hd, lens)
    out = chunked_prefill_attention(*args)
    want = ref.chunked_prefill_attention_ref(*args)
    torch.cuda.synchronize()
    for i, n in enumerate(lens):
        neg = max(sq - n, 0)
        assert torch.equal(out[i, :neg], torch.zeros_like(out[i, :neg]))
        torch.testing.assert_close(out[i, neg:].float(),
                                   want[i, neg:].float(), **tol(dtype))


def as_packs(cases):
    """Chunked cases as packs at ctx_lens = cache_lens - Sq."""
    return [(b, sq, smax, h, hkv, hd, [n - sq for n in lens])
            for b, sq, smax, h, hkv, hd, lens in cases]


# every packed case, and the chunked and negative-position cases as packs
BITWISE_CASES = PREFILL_CASES + as_packs(CHUNKED_CASES + NEGATIVE_CASES)
BITWISE_NEW = {**PREFILL_NEW, **{
    f"chunked_{k}": c for k, c in zip(CHUNKED_NEW, as_packs(
        list(CHUNKED_NEW.values())))}, **{
    f"negative_{k}": c for k, c in zip(NEGATIVE_NEW, as_packs(
        list(NEGATIVE_NEW.values())))}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **named(BITWISE_CASES, BITWISE_NEW))
def test_chunked_is_packed_per_segment_bitwise(cuda, dtype, case):
    """The JAX contract on the card: per segment, the packed kernel is the
    chunked kernel run alone at cache_lens = ctx_lens + Sq, bit for bit."""
    s, sq, smax, h, hkv, hd, ctx = case
    q, kc, vc, cl = prefill_inputs(cuda, dtype, s, sq, smax, h, hkv, hd, ctx)
    packed = packed_prefill_attention(q, kc, vc, cl)
    for i in range(s):
        one = chunked_prefill_attention(q[i:i + 1].contiguous(),
                                        kc[i:i + 1].contiguous(),
                                        vc[i:i + 1].contiguous(),
                                        cl[i:i + 1] + sq)
        torch.cuda.synchronize()
        assert torch.equal(one[0], packed[i])


def test_prefill_wrappers_refuse_tensors_off_16_bytes(cuda):
    """The kernel copies q, k and v in 16-byte chunks: a contiguous view
    that starts 4 bytes into its storage is refused before any launch."""
    q, kc, vc, cl = prefill_inputs(cuda, torch.float32, *PREFILL_CASES[2])
    p0 = packed_prefill_attention.launches
    c0 = chunked_prefill_attention.launches
    for i, t in enumerate((q, kc, vc)):
        off = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        off.copy_(t)
        args = [q, kc, vc]
        args[i] = off
        with pytest.raises(ValueError):
            packed_prefill_attention(*args, cl)
        with pytest.raises(ValueError):
            chunked_prefill_attention(*args, cl + q.shape[1])
    assert packed_prefill_attention.launches == p0
    assert chunked_prefill_attention.launches == c0


def verify_inputs(dev, dtype, n_seg, depth, h, hkv, hd, page, maxp, base,
                  n_pages=160, seed=0):
    """Rows (seg, j), j = 0..depth at length base[seg] + j + 1, over a
    compact (n_seg + 1, maxp) table whose last row is the zero pad row;
    two padding rows point at it with length 0."""
    rng = np.random.default_rng(seed)
    rows = n_seg * (depth + 1) + 2
    q = torch.as_tensor(rng.standard_normal((rows, h, hd)), dtype=dtype)
    kp = torch.as_tensor(rng.standard_normal((n_pages, page, hkv, hd)),
                         dtype=dtype)
    vp = torch.as_tensor(rng.standard_normal((n_pages, page, hkv, hd)),
                         dtype=dtype)
    bt = np.zeros((n_seg + 1, maxp), np.int32)
    bt[:n_seg] = rng.integers(1, n_pages, (n_seg, maxp))
    seg = np.full(rows, n_seg, np.int32)
    seg[:-2] = np.repeat(np.arange(n_seg), depth + 1)
    lens = np.zeros(rows, np.int32)
    lens[:-2] = (np.repeat(base, depth + 1)
                 + np.tile(np.arange(depth + 1), n_seg) + 1)
    return ([t.to(dev) for t in (q, kp, vp, torch.as_tensor(bt),
                                 torch.as_tensor(lens))],
            torch.as_tensor(seg))


VERIFY_CASES = [
    # n_seg, depth, h, hkv, hd, page, maxp, base lengths
    (16, 2, 16, 16, 64, 16, 48, [1, 15, 16, 30, 64, 100, 200, 333, 400,
                                 500, 511, 512, 513, 600, 700, 760]),
    (5, 1, 28, 4, 128, 16, 12, [0, 40, 77, 150, 180]),       # qwen2-7b
    (3, 3, 4, 2, 16, 8, 5, [3, 17, 30]),                      # smoke
    # one request's rows cross a split edge: 63..65 (4 pages, the ranks),
    # 255..257 (16 pages, every split), 1021..1023 (the 64-page table)
    (4, 2, 16, 16, 64, 16, 64, [62, 254, 1020, 5]),
]
VERIFY_NEW = {
    "glm_g16_hd128": (16, 2, 32, 2, 128, 16, 48,
                      [1, 15, 16, 30, 64, 100, 200, 333, 400, 500, 511, 512,
                       513, 600, 700, 760]),
    "hd8": (4, 2, 8, 2, 8, 16, 64, [62, 254, 1020, 5]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **named(VERIFY_CASES, VERIFY_NEW))
def test_packed_verify_matches_plain_and_decode_bitwise(cuda, dtype, case):
    (q, kp, vp, bt, ln), seg = verify_inputs(cuda, dtype, *case)
    out = packed_verify_attention(q, kp, vp, bt, ln, seg)
    torch.cuda.synchronize()
    want = ref.packed_verify_attention_ref(q, kp, vp, bt, ln, seg)
    # the two padding rows (length 0) see no key: 0, as in the TPU kernel
    # (the plain version's softmax over all-masked scores is not defined)
    torch.testing.assert_close(out[:-2].float(), want[:-2].float(),
                               **tol(dtype))
    assert torch.equal(out[-2:], torch.zeros_like(out[-2:]))
    # each row is the decode kernel's row on its gathered table, bitwise
    gathered = bt[seg.to(cuda).long()].contiguous()
    dec = paged_decode_attention(q, kp, vp, gathered, ln)
    torch.cuda.synchronize()
    assert torch.equal(out, dec)


def test_paged_wrappers_refuse_pages_off_16_bytes(cuda):
    """The decode / verify kernel copies K/V rows in 16-byte pieces: pages
    that start 4 bytes into their storage, or a head_dim it does not
    instantiate (24: no config has it), are refused before any launch."""
    q, kp, vp, bt, ln = decode_inputs(cuda, torch.float32, *DECODE_CASES[2])
    seg = torch.zeros(q.shape[0], dtype=torch.int32)
    d0 = paged_decode_attention.launches
    v0 = packed_verify_attention.launches
    for i, t in enumerate((kp, vp)):
        off = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        off.copy_(t)
        pages = [kp, vp]
        pages[i] = off
        with pytest.raises(ValueError):
            paged_decode_attention(q, *pages, bt, ln)
        with pytest.raises(ValueError):
            packed_verify_attention(q, *pages, bt, ln, seg)
    with pytest.raises(ValueError):
        paged_decode_attention(*(torch.cat([t, t[..., :8]], -1)
                                 for t in (q, kp, vp)), bt, ln)
    assert paged_decode_attention.launches == d0
    assert packed_verify_attention.launches == v0


def test_dispatch_routes_cuda_tensors_to_the_kernels(cuda):
    d0 = paged_decode_attention.launches
    p0 = packed_prefill_attention.launches
    ops.paged_decode_attention(*decode_inputs(cuda, torch.float32,
                                              *DECODE_CASES[2]))
    ops.packed_prefill_attention(*prefill_inputs(cuda, torch.float32,
                                                 *PREFILL_CASES[2]))
    assert paged_decode_attention.launches == d0 + 1
    assert packed_prefill_attention.launches == p0 + 1
    assert ops.launch_counts()["paged_decode_attention"] == d0 + 1
    assert ops.launch_counts()["packed_prefill_attention"] == p0 + 1
    c0 = chunked_prefill_attention.launches
    v0 = packed_verify_attention.launches
    ops.chunked_prefill_attention(*prefill_inputs(cuda, torch.float32,
                                                  *CHUNKED_CASES[3]))
    args, seg = verify_inputs(cuda, torch.float32, *VERIFY_CASES[2])
    ops.packed_verify_attention(*args, seg)
    assert ops.launch_counts()["chunked_prefill_attention"] == c0 + 1
    assert ops.launch_counts()["packed_verify_attention"] == v0 + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, kp, vp, bt, ln = decode_inputs(cuda, torch.float32, *DECODE_CASES[2])
    n0 = paged_decode_attention.launches
    with pytest.raises(TypeError):
        paged_decode_attention(q.double(), kp.double(), vp.double(), bt, ln)
    with pytest.raises(TypeError):
        paged_decode_attention(q, kp, vp, bt.long(), ln)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, bt.cpu(), ln)
    with pytest.raises(ValueError):
        paged_decode_attention(q.transpose(0, 1).contiguous()
                               .transpose(0, 1), kp, vp, bt, ln)
    with pytest.raises(ValueError):
        paged_decode_attention(q.cpu(), kp.cpu(), vp.cpu(), bt.cpu(),
                               ln.cpu())
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :3].contiguous(), kp, vp, bt,
                               ln)                 # H % Hkv != 0
    q2, kc, vc, cl = prefill_inputs(cuda, torch.float32, *PREFILL_CASES[2])
    p0 = packed_prefill_attention.launches
    with pytest.raises(ValueError):
        packed_prefill_attention(q2, kc[:1], vc[:1], cl)
    with pytest.raises(ValueError):       # head_dim 24: no config has it
        packed_prefill_attention(*(torch.cat([t, t[..., :8]], -1)
                                   for t in (q2, kc, vc)), cl)
    with pytest.raises(TypeError):
        packed_prefill_attention(q2.half(), kc.half(), vc.half(), cl)
    assert paged_decode_attention.launches == n0
    assert packed_prefill_attention.launches == p0
    c0 = chunked_prefill_attention.launches
    with pytest.raises(ValueError):
        chunked_prefill_attention(q2, kc, vc, cl[:1])
    with pytest.raises(TypeError):
        chunked_prefill_attention(q2, kc, vc, cl.long())
    with pytest.raises(TypeError):
        chunked_prefill_attention(q2.double(), kc.double(), vc.double(), cl)
    with pytest.raises(ValueError):
        chunked_prefill_attention(q2.cpu(), kc, vc, cl)
    assert chunked_prefill_attention.launches == c0
    (vq, vk, vv, vbt, vln), seg = verify_inputs(cuda, torch.float32,
                                                *VERIFY_CASES[2])
    v0 = packed_verify_attention.launches
    n_tab = vbt.shape[0]
    for bad in (seg.clone().fill_(n_tab), seg.clone().fill_(-1)):
        with pytest.raises(IndexError):
            packed_verify_attention(vq, vk, vv, vbt, vln, bad)
    with pytest.raises(TypeError):
        packed_verify_attention(vq, vk, vv, vbt, vln, seg.float())
    with pytest.raises(ValueError):
        packed_verify_attention(vq, vk, vv, vbt, vln, seg[:-1])
    with pytest.raises(ValueError):
        packed_verify_attention(vq, vk, vv, vbt, vln[:-1], seg)
    with pytest.raises(TypeError):
        packed_verify_attention(vq.half(), vk.half(), vv.half(), vbt, vln,
                                seg)
    with pytest.raises(TypeError):
        packed_verify_attention(vq, vk, vv, vbt.long(), vln, seg)
    with pytest.raises(ValueError):
        packed_verify_attention(vq, vk, vv, vbt.cpu(), vln, seg)
    # a CUDA row_seg is fetched for the check, then launched
    packed_verify_attention(vq, vk, vv, vbt, vln, seg.to(cuda))
    assert packed_verify_attention.launches == v0 + 1


def test_engine_on_card_matches_greedy_forward(cuda):
    """Smoke-width serve run on the card: every stream equals greedy
    decoding by the port's own forward, and each kernel launched once per
    layer per engine launch."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import greedy_generate, init_params

    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    ops.reset_launch_counts()
    res = serve.serve(cfg, params, serve.SMOKE, device=cuda)
    counts = ops.launch_counts()
    st = res.engine.stats
    assert st.evictions > 0 and st.cache_hit_tokens > 0
    assert counts["paged_decode_attention"] == cfg.n_layers * \
        st.decode_launches
    assert counts["packed_prefill_attention"] == cfg.n_layers * \
        st.packed_prefill_calls
    assert st.host_syncs == st.decode_launches + st.packed_prefill_calls
    for r, prompt in res.requests:
        assert res.engine.outputs[r.rid] == greedy_generate(
            cfg, params, prompt, r.output_len)


def test_glm_engine_on_card_matches_greedy_forward(cuda):
    """ChatGLM3-6B at its full width (H 32 / Hkv 2, so G 16, head_dim 128,
    d_model 4096, vocab 65024, half-rotary RoPE, QKV bias) cut to two
    layers, smoke traffic: every stream equals greedy decoding by the
    port's forward, each attention kernel launched once per layer per
    engine launch."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models.model import greedy_generate, init_params

    cfg = dataclasses.replace(get("chatglm3_6b"), n_layers=2)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    ops.reset_launch_counts()
    res = serve.serve(cfg, params, serve.SMOKE, device=cuda)
    counts = ops.launch_counts()
    st = res.engine.stats
    assert counts["paged_decode_attention"] == cfg.n_layers * \
        st.decode_launches > 0
    assert counts["packed_prefill_attention"] == cfg.n_layers * \
        st.packed_prefill_calls > 0
    for r, prompt in res.requests:
        assert res.engine.outputs[r.rid] == greedy_generate(
            cfg, params, prompt, r.output_len)
    res.engine.kill()


QUANT_CASES = [
    (8, 24, 16, 16, 64),      # one demoted Qwen1.5-0.5B group
    (3, 2, 4, 2, 16),         # smoke widths
    (2, 3, 3, 1, 5),          # rows of 15 values: the scalar path
]
QUANT_NEW = {
    "glm": (8, 28, 16, 2, 128),          # ChatGLM3-6B: one block per row
    # 131072 values a row: more slices than the cluster's 8 blocks (fp32
    # 32 slices, bf16 16), so each block loops over its slices
    "multi_slice": (2, 2, 32, 32, 128),
    "ragged_slice": (2, 3, 16, 3, 200),  # 9600 values: a partial last slice
    "narrow_rows": (2, 2, 3, 1, 8),      # 24 values: no 16-byte int8 store
}


def quant_blocks(dev, dtype, n, lyr, bs, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n, lyr, 2, bs, hkv, hd)) * 3,
                        dtype=torch.float32)
    x[0, 0, 1] = 0.0                                     # a zero plane
    e = bs * hkv * hd
    half = torch.arange(e, dtype=torch.float32) % 254 - 126.5
    half[0] = 127.0                                      # scale 1
    x[-1, -1, 0] = half.reshape(bs, hkv, hd)             # half steps
    return x.to(dtype).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", **named(QUANT_CASES, QUANT_NEW))
def test_kv_quant_bitwise_equals_plain(cuda, dtype, case):
    x = quant_blocks(cuda, dtype, *case)
    vals, scales = kv_block_quantize(x)
    want_v, want_s = ref.kv_block_quantize_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(vals, want_v) and torch.equal(scales, want_s)
    out = kv_block_dequantize(vals, scales)
    assert torch.equal(out, ref.kv_block_dequantize_ref(vals, scales))


GATHER_CASES = [
    # pool shape, block_dim, indices
    ((24, 2, 160, 16, 16, 64), 2, [3, 159, 0, 77, 3, 12, 140, 9]),
    ((160, 16, 16, 64), 0, [5, 1, 159, 40, 41, 42, 0, 100]),
    ((7, 3, 5, 3), 0, [6, 0, 3]),              # rows of 45 values: no uint4
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("case", GATHER_CASES)
def test_block_gather_bitwise_equals_plain(cuda, dtype, case):
    shape, dim, idx = case
    g = torch.Generator().manual_seed(len(idx))
    pool = (torch.randn(shape, generator=g) * 50).to(dtype).to(cuda)
    got = block_gather(pool, torch.tensor(idx, dtype=torch.int32), dim)
    want = ref.block_gather_ref(pool, idx, dim)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, want)


def test_copy_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = quant_blocks(cuda, torch.float32, *QUANT_CASES[1])
    vals, scales = kv_block_quantize(x)
    n0 = ops.launch_counts()
    with pytest.raises(ValueError):
        kv_block_quantize(x.cpu())
    with pytest.raises(TypeError):
        kv_block_quantize(x.double())
    with pytest.raises(ValueError):
        kv_block_quantize(x[:, :, :1].contiguous())      # not (.., 2, ..)
    with pytest.raises(ValueError):
        kv_block_quantize(x.transpose(0, 1))             # not contiguous
    with pytest.raises(TypeError):
        kv_block_dequantize(vals.float(), scales)
    with pytest.raises(ValueError):
        kv_block_dequantize(vals, scales[:1].contiguous())
    with pytest.raises(ValueError):
        kv_block_dequantize(vals.cpu(), scales.cpu())
    pool = torch.zeros(10, 4, 2, 8, device=cuda)
    with pytest.raises(IndexError):
        block_gather(pool, torch.tensor([0, 10]))
    with pytest.raises(IndexError):
        block_gather(pool, torch.tensor([-1]))
    with pytest.raises(ValueError):
        block_gather(pool.cpu(), torch.tensor([0]))
    with pytest.raises(TypeError):
        block_gather(pool, torch.tensor([0.0]))
    assert ops.launch_counts() == n0


def test_side_stream_launch_is_ordered_against_the_main_stream(cuda):
    """A gather launched on the main stream and quantized on a side stream
    that waits on it (the transfer worker's pattern), then consumed back
    on the main stream after waiting on the side stream's event."""
    kv = torch.zeros(24, 2, 64, 16, 16, 64, device=cuda)
    side = torch.cuda.Stream(cuda)
    for trial in range(3):
        kv.fill_(float(trial + 1))          # queued on the main stream
        snap = block_gather(kv, torch.tensor([5, 6, 7]), 2)
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(side):
            side.wait_event(ready)
            snap.record_stream(side)
            vals, scales = kv_block_quantize(snap)
            out = kv_block_dequantize(vals, scales)
            done = torch.cuda.Event()
            done.record(side)
        torch.cuda.current_stream().wait_event(done)
        out.record_stream(torch.cuda.current_stream())
        assert torch.equal(out, torch.full_like(out, float(trial + 1)))


def test_tiered_engine_on_card(cuda):
    """Smoke-width tiered serve on the card, exact fp32 cold tier: the
    streams equal greedy decoding by the port's forward, no background
    copy fails, and each copy kernel launched as often as its callers
    counted."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import greedy_generate, init_params

    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    ops.reset_launch_counts()
    res = serve.serve(cfg, params, serve.TIERED_SMOKE, device=cuda,
                      cold_quantize=False)
    counts = ops.launch_counts()
    eng = res.engine
    st = eng.stats
    assert st.transfer_failures == 0 and st.offload_blocks > 0
    assert st.spill_blocks > 0 and eng.pool.tier.demoted_blocks > 0
    assert counts["block_gather"] == eng.pool.gather_calls
    assert counts["kv_block_dequantize"] == (
        eng.pool.dequantize_calls + eng.pool.tier.dequantize_calls
        + eng.worker.dequantize_calls)
    for r, prompt in res.requests:
        assert eng.outputs[r.rid] == greedy_generate(cfg, params, prompt,
                                                     r.output_len)
    eng.kill()


def test_lanes_off_serve_on_card(cuda):
    """The synchronous-copy engine (``overlap_transfers=False``) on the
    card: smoke-width serve traffic with preemption, streams equal to
    greedy decoding, one host sync per model launch, each attention kernel
    launched n_layers x the engine's launches and the gather as often as
    the pool called it."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import greedy_generate, init_params

    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(1),
                         device=cuda)
    ops.reset_launch_counts()
    res = serve.serve(cfg, params, serve.SMOKE, device=cuda,
                      overlap_transfers=False)
    counts = ops.launch_counts()
    eng = res.engine
    st = eng.stats
    assert eng.worker is None and st.evictions > 0
    assert st.host_syncs == st.decode_launches + st.packed_prefill_calls
    assert counts["paged_decode_attention"] == cfg.n_layers * st.decode_launches
    assert counts["packed_prefill_attention"] == (
        cfg.n_layers * st.packed_prefill_calls)
    assert counts["block_gather"] == eng.pool.gather_calls
    for r, prompt in res.requests:
        assert eng.outputs[r.rid] == greedy_generate(cfg, params, prompt,
                                                     r.output_len)
    eng.kill()


@pytest.mark.parametrize("draft_seed", [0, 7], ids=["same", "other"])
def test_spec_engine_on_card_matches_greedy_forward(cuda, draft_seed):
    """Smoke-width serve with speculative decoding (spec_k = 2) on the
    card, the draft's weights the target's or another seed's: every stream
    equals greedy decoding by the port's forward, and the verify kernel
    launched once per layer per decode launch."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import greedy_generate, init_params

    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    draft = params if draft_seed == 0 else init_params(
        cfg, torch.Generator(cuda).manual_seed(draft_seed), device=cuda)
    ops.reset_launch_counts()
    res = serve.serve(cfg, params, serve.SMOKE, device=cuda, spec_k=2,
                      draft=(cfg, draft))
    counts = ops.launch_counts()
    eng = res.engine
    st = eng.stats
    assert st.spec_proposed > 0
    assert st.spec_proposed == st.spec_accepted + st.spec_rejected
    if draft_seed:
        assert st.spec_rejected > 0
    assert counts["packed_verify_attention"] == cfg.n_layers * \
        st.decode_launches
    assert counts["paged_decode_attention"] == cfg.n_layers * \
        eng.draft.syncs
    assert counts["chunked_prefill_attention"] == cfg.n_layers * (
        eng.draft.launches - eng.draft.syncs)
    assert st.host_syncs == (st.decode_launches + st.packed_prefill_calls
                             + eng.draft.syncs)
    for r, prompt in res.requests:
        assert eng.outputs[r.rid] == greedy_generate(cfg, params, prompt,
                                                     r.output_len)
    eng.kill()


def test_per_request_engine_on_card_matches_greedy_forward(cuda):
    """Smoke-width serve on the per-request paths (packed_prefill=False,
    fused_decode=False) on the card: exact streams, the chunked kernel
    launched once per layer per prefill_chunk call."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import greedy_generate, init_params

    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(2),
                         device=cuda)
    ops.reset_launch_counts()
    res = serve.serve(cfg, params, serve.SMOKE, device=cuda,
                      packed_prefill=False, fused_decode=False)
    counts = ops.launch_counts()
    eng = res.engine
    st = eng.stats
    assert st.packed_prefill_calls == 0 and st.prefill_chunk_calls > 0
    assert counts["chunked_prefill_attention"] == cfg.n_layers * \
        st.prefill_chunk_calls
    assert counts["paged_decode_attention"] == cfg.n_layers * \
        st.decode_launches
    assert counts["packed_prefill_attention"] == 0
    assert st.host_syncs == st.decode_launches + len(res.requests)
    for r, prompt in res.requests:
        assert eng.outputs[r.rid] == greedy_generate(cfg, params, prompt,
                                                     r.output_len)
    eng.kill()


def disagg_fleet(cuda, params_seed, int8, roles=("prefill", "decode"),
                 after_round=None, num_blocks=None):
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(params_seed),
                         device=cuda)
    traffic = serve.SMOKE if num_blocks is None else dataclasses.replace(
        serve.SMOKE, num_blocks=num_blocks)
    ops.reset_launch_counts()
    res = serve.serve_fleet(cfg, params, traffic, roles=roles,
                            pd_mode="disagg", device=cuda,
                            handoff_int8=int8, after_round=after_round)
    return cfg, params, res, ops.launch_counts()


def check_handoff_launches(res, counts):
    """block_gather, kv_block_quantize and kv_block_dequantize launched
    exactly as often as the fleet's pools, tier stores and workers called
    them, and at least once per export / adoption."""
    engines = res.replicas
    s = res.summary()
    assert counts["block_gather"] == sum(e.pool.gather_calls
                                         for e in engines)
    assert counts["kv_block_quantize"] == sum(
        e.pool.quantize_calls + e.pool.tier.quantize_calls for e in engines)
    assert counts["kv_block_dequantize"] == sum(
        e.pool.dequantize_calls + e.pool.tier.dequantize_calls
        + (e.worker.dequantize_calls if e.worker else 0) for e in engines)
    assert counts["block_gather"] >= s["handoffs_out"] > 0
    assert s["transfer_failures"] == 0


def test_disagg_fleet_on_card_matches_greedy_forward(cuda):
    """Smoke-width 1 prefill + 1 decode fleet on the card, fp32 wire:
    every stream equals greedy decoding by the port's forward, every
    request crossed the handoff, and the copy kernels launched as often as
    their callers counted."""
    from repro_torch.models.model import greedy_generate

    cfg, params, res, counts = disagg_fleet(cuda, 0, False)
    s = res.summary()
    assert s["handoffs_out"] == s["handoffs_in"] == s["handoffs"] == 12
    assert s["handoff_bytes_out"] == (
        s["handoff_blocks_out"] * res.replicas[0].pool.tier.block_bytes)
    check_handoff_launches(res, counts)
    assert counts["kv_block_quantize"] == counts["kv_block_dequantize"] == 0
    for r, prompt in res.requests:
        assert res.outputs[r.rid] == greedy_generate(cfg, params, prompt,
                                                     r.output_len)
    for e in res.replicas:
        e.kill()


def test_disagg_int8_fleet_on_card_is_deterministic(cuda):
    """The int8 wire on the card, run twice: identical streams and wire
    bytes, narrower than fp32; one kv_block_quantize launch per export and
    one kv_block_dequantize launch per adoption.  The pools hold the whole
    traffic, so the decode replica never evicts and recomputes (which
    would give that request exact KV where the wire gives int8, at a
    point the timing-driven schedule picks)."""
    runs = []
    for _ in range(2):
        _, _, res, counts = disagg_fleet(cuda, 0, True, num_blocks=128)
        s = res.summary()
        pe, de = res.replicas
        assert de.stats.evictions == de.stats.prefill_tokens == 0
        assert s["handoff_bytes_out"] < (s["handoff_blocks_out"]
                                         * pe.pool.tier.block_bytes)
        check_handoff_launches(res, counts)
        assert counts["kv_block_quantize"] == pe.pool.quantize_calls == \
            s["handoffs_out"]
        assert counts["kv_block_dequantize"] == s["handoffs_in"]
        first = res.requests[0][0].rid
        runs.append(({r.rid - first: res.outputs[r.rid]
                      for r, _ in res.requests}, s["handoff_bytes_out"]))
        for e in res.replicas:
            e.kill()
    assert runs[0] == runs[1]


def test_disagg_churn_on_card_matches_greedy_forward(cuda):
    """prefill + decode + coloc on the card, the decode replica killed
    after its first adoption: every stream still equals greedy
    decoding, each token emitted once."""
    from repro_torch.models.model import greedy_generate

    killed = []

    def after_round(ctl):
        for iid, eng in list(ctl.engines.items()):
            if eng.role == "decode" and eng.stats.handoffs_in and not killed:
                killed.append(iid)
                ctl.kill_instance(iid)

    cfg, params, res, counts = disagg_fleet(
        cuda, 1, False, roles=("prefill", "decode", "coloc"),
        after_round=after_round)
    assert killed
    check_handoff_launches(res, counts)
    for r, prompt in res.requests:
        assert res.outputs[r.rid] == greedy_generate(cfg, params, prompt,
                                                     r.output_len)
        assert len(res.emitted[r.rid]) == r.output_len
    for e in res.replicas:
        e.kill()
