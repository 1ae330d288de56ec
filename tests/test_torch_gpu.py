"""CUDA kernels of the PyTorch port against their plain versions, on the
card.  Run there with ``python -m pytest -m gpu tests/test_torch_gpu.py``;
without a card every test skips (decided inside the ``cuda`` fixture, so
all workers collect the same tests).  Imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_gather import block_gather
from repro_torch.kernels.chunked_prefill import packed_prefill_attention
from repro_torch.kernels.kv_quant import kv_block_dequantize, kv_block_quantize
from repro_torch.kernels.paged_attention import paged_decode_attention

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


DECODE_CASES = [
    # b, h, hkv, hd, page, maxp, lens
    (16, 16, 16, 64, 16, 12, [1, 16, 17, 191, 192, 100, 5, 33,
                              64, 65, 2, 150, 180, 8, 120, 77]),   # qwen1.5
    (5, 28, 4, 128, 16, 9, [1, 144, 70, 16, 99]),                  # qwen2-7b
    (3, 4, 2, 16, 8, 5, [1, 40, 23]),                              # smoke
    (2, 8, 1, 32, 32, 3, [96, 31]),                                # G=8
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_decode_matches_plain(cuda, dtype, case):
    b, h, hkv, hd, page, maxp, lens = case
    args = decode_inputs(cuda, dtype, b, h, hkv, hd, page, maxp, lens)
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(*args)
    torch.testing.assert_close(out.float(), want.float(), **tol(dtype))


PREFILL_CASES = [
    # s, sq, smax, h, hkv, hd, ctx
    (4, 128, 512, 16, 16, 64, [0, 384, 100, 17]),                  # qwen1.5
    (3, 64, 192, 28, 4, 128, [0, 128, 61]),                        # qwen2-7b
    (2, 16, 48, 4, 2, 16, [0, 32]),                                # smoke
    (2, 40, 64, 6, 2, 32, [24, 3]),                                # ragged
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES)
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
    with pytest.raises(ValueError):
        packed_prefill_attention(q2[..., :8].contiguous(),
                                 kc[..., :8].contiguous(),
                                 vc[..., :8].contiguous(), cl)
    with pytest.raises(TypeError):
        packed_prefill_attention(q2.half(), kc.half(), vc.half(), cl)
    assert paged_decode_attention.launches == n0
    assert packed_prefill_attention.launches == p0


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


QUANT_CASES = [
    (8, 24, 16, 16, 64),      # one demoted Qwen1.5-0.5B group
    (3, 2, 4, 2, 16),         # smoke widths
    (2, 3, 3, 1, 5),          # rows of 15 values: the scalar path
]


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
@pytest.mark.parametrize("case", QUANT_CASES)
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
