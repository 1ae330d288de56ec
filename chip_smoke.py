"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py            # needs one CUDA card; no arguments
    python3 chip_smoke.py --profile  # also: lanes off/on walls and host
                                     # profile, device time by kernel for
                                     # the serve, tiered, spec and
                                     # per-request traffic (build/profile)

Phases (any failure exits non-zero; nothing is caught and continued):
  1. env     — the card's name and power limit (nvidia-smi), torch / CUDA.
  2. build   — every ``src/repro_torch/csrc/*.cu`` compiled with nvcc for
               sm_90a (``-Xptxas -v``): registers, shared memory and spills
               of each kernel; no instance of the tensor-core prefill body
               (``packed_prefill.cu``) or of the cluster-split decode body
               (``paged_attention.cu``) may spill.
  3. kernels — each CUDA kernel held against its plain PyTorch version at
               the serve phase's shapes (Qwen1.5-0.5B: H = Hkv = 16,
               hd 64, page 16) and, for the attention kernels, at
               Qwen2-7B's GQA widths (H 28, Hkv 4, hd 128): attention at
               fp32 atol = rtol = 2e-5, the copy kernels (int8 quantize /
               dequantize of one demoted group of 8 blocks (8, 24, 2, 16,
               16, 64), block gather) bitwise.  The chunked prefill kernel
               (a 512-token prompt ingest against a 1024-position staging
               span) and the packed verify kernel (16 requests x 3 rows over
               a 48-page table) at fp32 2e-5 and bf16 2e-2, and their JAX
               contracts bitwise on the card: chunked per request = packed
               per segment at cache_lens = ctx_lens + Sq; each verify row =
               the decode row on tables[row_seg].  Then each kernel is
               timed with CUDA events (cold and warm L2) beside the plain
               version and, where one PyTorch call computes the same
               function, that call (a yardstick the port never calls).
               The prefill kernels' bf16 instances are also held at 2e-2
               and timed beside SDPA in bf16 at the same shapes (printed,
               not in the JSON line); their bounds take the tensor cores'
               rate (fp32 as 3xTF32: 165 TFLOP/s; bf16: 989 TFLOP/s).
               The decode and verify kernels' bf16 instances are held at
               2e-2 and timed beside their plain versions the same way,
               and the decode instance's cluster size, shared memory per
               block and residency are printed for each width.  Then the
               shapes opened last: ChatGLM3-6B's G 16 at hd 128 (decode
               and verify in two head groups of 8) and head_dim 8, decode,
               verify, packed and chunked prefill, fp32 and bf16, against
               the plain versions, with verify = decode and chunked =
               packed bitwise and, at G 16, a head's bits the same in
               either head group (times printed); and kv_block_quantize
               bitwise at ChatGLM3-6B's block width (8, 28, 2, 16, 2,
               128), fp32 and bf16 in, and at 26 Qwen1.5-0.5B blocks (the
               tiered pass's median call), each timed (printed).
  4. serve   — the port's entry point ``repro_torch.launch.serve`` at the
               full width of Qwen1.5-0.5B (24 layers, fp32, random weights
               from seed 0): two waves of multi-priority requests with
               prefix-cache hits and preemption, KV copies on the
               background transfer lanes.  Every stream must equal greedy
               decoding by the port's own full-sequence forward; each
               attention kernel's launch count must equal n_layers x the
               engine's launches of its step, and each copy kernel's the
               calls counted by the pool, the tier store and the worker;
               host syncs must equal model launches; offloads must land
               with a measured copy time and no failed copy.  Then the same
               traffic with the lanes off (``--no-overlap``, synchronous
               copies): the same stream, launch-count and sync gates.
  5. tiered  — ``serve --tiered`` at the same width and depth: a host tier
               of 8 blocks, prefix-cache spill, a batch cap that leaves
               preempted requests on host, and a third wave resending the
               earlier prompts.  (a) With the exact fp32 cold tier every
               stream equals greedy forward, and reloads, staged reloads or
               restores, demotions and spills all happen.  (b) With the
               int8 cold tier every request completes, both kv_quant
               kernels launch as often as the tiers called them, and every
               quantized plane comes back within scale / 2; the quantize
               calls are printed by their number of blocks.
  6. spec    — ``serve --spec-k 2`` on the serve traffic, with a draft of
               the target's weights and with one from seed 7: every stream
               equals greedy forward; proposed = accepted + rejected; the
               same-weights draft has at least 90 % accepted (each refuted
               position printed with greedy forward's top-2 margin) and
               fewer target decode launches than the serve phase; the
               other draft has rejections.  The verify kernel launches
               n_layers x the decode launches, the draft's decode rounds
               and ingests add to the decode and chunked kernels, and host
               syncs equal target launches + draft rounds.
  7. per-request — ``serve --per-request`` (one prefill_chunk call per
               chunk, the logits decode): exact streams; the chunked kernel
               launches n_layers x the prefill_chunk calls; host syncs equal
               decode launches + prompt completions.
  8. glm     — ``serve --arch chatglm3_6b`` at its full published width (28
               layers, d_model 4096, H 32 / Hkv 2, hd 128, d_ff 13696,
               vocab 65024; ~25 GB of fp32 weights from seed 0, nothing
               cut) on the serve traffic: evictions, exact streams, the
               serve phase's launch-count and host-sync gates; its wall,
               peak memory and launches printed.
  9. disagg  — ``serve --pd disagg`` at Qwen1.5-0.5B's full width on the
               serve traffic: a ``ServiceController`` with GoRouting over
               prefill- and decode-role engines sharing one params dict,
               each request's KV handed over through host memory.  (a) 1
               prefill + 1 decode replica, fp32 wire: every stream equals
               greedy forward; exports = adoptions = the book's handoffs
               = the requests with more than one output token; wire bytes
               = blocks x block bytes; every reservation settled (reserved
               = adopted when none missed); block_gather launched at least
               once per export; no export state, reservation, used block
               or request host-tier group left.  (b) ``--handoff-int8`` on
               1 prefill + 2 decode replicas (so the decode leg never
               evicts and recomputes), twice: identical streams and wire
               bytes, a narrower wire, kv_block_quantize launched once per
               export and kv_block_dequantize once per adoption, every
               quantized plane within scale / 2; the streams equal to
               greedy are printed, not gated.  (c) prefill + decode +
               coloc, the decode replica killed after its first adoption:
               every stream equals greedy forward, each token emitted
               once.  Each pass under the serve phase's launch-count and
               host-sync gates; walls, TTFT / TPOT, handoff blocks, bytes
               and copy time, reservations and peak memory printed.

fp32 matmuls run in full fp32: TF32 is switched off for cuBLAS and cuDNN.
The last two lines are the ``{"kernels": ...}`` JSON and the
``{"ok": true, ...}`` JSON.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: three TF32 products (495
# TFLOP/s dense) per product, as the prefill kernels compute fp32
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores
TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


L2_FLUSH_BYTES = 128 << 20     # > the H100's 50 MB L2


# device cycles (~0.1 ms) the stream spins before each timed call, so the
# host has enqueued the whole call before the start event is reached and
# a call shorter than its Python wrapper is not timed as host latency
SPIN_CYCLES = 200_000


def time_ms(fn, iters: int = 30, warmup: int = 3,
            cold_l2: bool = True) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around each call,
    with L2 flushed before each one unless ``cold_l2`` is False: in the
    engine every layer's call reads another layer's pool, so the caller
    finds the cache cold."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        if cold_l2:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# --------------------------------------------------------------------------
# kernels phase: inputs, bounds, comparison
# --------------------------------------------------------------------------

def decode_case(rng, b, h, hkv, hd, page, maxp, lens, dev):
    n_pages = b * maxp + 1
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    q = t(rng.standard_normal((b, h, hd)))
    kp = t(rng.standard_normal((n_pages, page, hkv, hd)))
    vp = t(rng.standard_normal((n_pages, page, hkv, hd)))
    bt = t(1 + rng.permutation(n_pages - 1)[:b * maxp].reshape(b, maxp),
           torch.int32)
    return q, kp, vp, bt, t(lens, torch.int32)


def decode_bound(q, kp, bt, lens) -> tuple[float, str]:
    """Least time for the work these inputs need: live K/V rows, q, the
    tables and lengths read once, the output written once (K/V, q and the
    output at their element size); 4 flops per (query head, live
    position, dim) for QK^T and PV."""
    b, h, hd = q.shape
    hkv = kp.shape[2]
    live = int(lens.sum())
    nbytes = (2 * live * hkv * hd + 2 * b * h * hd) * q.element_size() \
        + bt.numel() * 4 + lens.numel() * 4
    flops = 4 * live * h * hd
    return bound(nbytes, flops)


def prefill_case(rng, s, sq, smax, h, hkv, hd, ctx, dev):
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(rng.standard_normal((s, sq, h, hd))),
            t(rng.standard_normal((s, smax, hkv, hd))),
            t(rng.standard_normal((s, smax, hkv, hd))),
            t(ctx, torch.int32))


def prefill_bound(q, kc, ctx) -> tuple[float, str]:
    """Each segment reads the K/V rows up to its causal horizon
    min(Smax, ctx + Sq) once; query row r sees min(Smax, ctx + r + 1)
    keys at 4 flops per (head, key, dim).  The operations run at the
    tensor cores' rate for the kernel's arithmetic: 165 TFLOP/s for fp32
    (3xTF32: three TF32 products at 495 TFLOP/s per fp32-accurate
    product), 989 TFLOP/s for bf16; bytes at the element size.  (Until
    the kernels ran on the tensor cores, fp32 was bounded at the CUDA
    cores' 67 TFLOP/s.)"""
    s, sq, h, hd = q.shape
    smax, hkv = kc.shape[1], kc.shape[2]
    keys = 0
    kv_rows = 0
    for c in ctx.tolist():
        r = np.arange(sq)
        keys += int(np.minimum(smax, c + r + 1).sum())
        kv_rows += min(smax, c + sq)
    size = q.element_size()
    nbytes = (2 * kv_rows * hkv * hd + 2 * s * sq * h * hd) * size + s * 4
    flops = 4 * keys * h * hd
    return bound(nbytes, flops, BF16_FLOPS_PER_S if q.dtype ==
                 torch.bfloat16 else TF32X3_FLOPS_PER_S)


def bound(nbytes: int, flops: int,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rows=None) -> float:
    torch.cuda.synchronize()
    if rows is not None:
        got, want = rows(got), rows(want)
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    try:
        torch.testing.assert_close(got, want, **(BF16_TOL if bf16 else TOL))
    except AssertionError as e:
        fail(f"{name} disagrees with its plain version: {e}")
    print(f"  {name}: max_abs_err {err:.3e} ("
          f"{'bf16 atol=rtol=2e-2' if bf16 else 'fp32 atol=rtol=2e-5'}) ok",
          flush=True)
    return err


def bitwise(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """A kernel against another kernel that must give the same bits."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"{name}: not bitwise equal")
    print(f"  {name}: bitwise equal", flush=True)


def sdpa_inputs(q, kc, vc, ctx):
    """The same packed-prefill function as one SDPA call: (S, H, Sq, hd)
    queries, (S, Hkv, Smax, hd) keys/values, mask k_pos <= ctx + r."""
    sq, smax = q.shape[1], kc.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kt = kc.transpose(1, 2).contiguous()
    vt = vc.transpose(1, 2).contiguous()
    r = torch.arange(sq, device=q.device)
    k = torch.arange(smax, device=q.device)
    mask = k[None, None, :] <= (ctx[:, None, None] + r[None, :, None])
    return qt, kt, vt, mask[:, None]


def real_rows(ctx, sq, smax):
    """Rows a real chunk can have (position < Smax); the rest is padding
    the engine discards."""
    return lambda t: torch.cat([t[i, :min(sq, smax - c)].reshape(-1)
                                for i, c in enumerate(ctx.tolist())])


def turns(kernel, plain) -> tuple[list, list]:
    """Kernel and plain times taken as (plain, kernel, kernel, plain)."""
    p0 = time_ms(plain)
    k = [time_ms(kernel), time_ms(kernel)]
    return k, [p0, time_ms(plain)]


def bf16_prefill(name, kernel, plain, args, ctx, rows=None) -> dict:
    """The bf16 instance of a prefill kernel at an fp32 row's shape:
    held at 2e-2 against its plain version and timed beside SDPA in bf16
    (printed; the JSON line keeps the fp32 rows)."""
    import torch.nn.functional as F
    q, kc, vc, _ = args
    err = compare(f"{name} (bf16)", kernel(*args), plain(*args), rows)
    sdpa = sdpa_inputs(q, kc, vc, ctx)
    k, p = turns(lambda: kernel(*args), lambda: plain(*args))
    b = prefill_bound(q, kc, ctx)
    return dict(
        max_abs_err=err, ms=float(np.mean(k)),
        warm_l2_ms=time_ms(lambda: kernel(*args), cold_l2=False),
        plain_ms=float(np.mean(p)), library_ms=time_ms(
            lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3],
                enable_gqa=True)),
        bound_ms=b[0], bound_by=b[1],
        shape=f"q {tuple(q.shape)} kv {tuple(kc.shape)} bf16")


def measure(name, kernel, plain, args, bound_fn, rows=None,
            library=None) -> dict:
    """A kernel held against its plain version (fp32 2e-5, bf16 2e-2) and
    timed beside it in turns, cold and warm L2, and beside ``library``
    where one PyTorch call computes the same function."""
    err = compare(name, kernel(*args), plain(*args), rows)
    k, p = turns(lambda: kernel(*args), lambda: plain(*args))
    b = bound_fn(*args)
    return dict(
        max_abs_err=err, ms=float(np.mean(k)),
        warm_l2_ms=time_ms(lambda: kernel(*args), cold_l2=False),
        plain_ms=float(np.mean(p)),
        library_ms=time_ms(library) if library else None, bound_ms=b[0],
        bound_by=b[1], shape=f"q {tuple(args[0].shape)} kv "
        f"{tuple(args[1].shape)} {str(args[0].dtype)[6:]}")


def print_launch_shape(q, kp) -> None:
    """The decode kernel's cluster size, shared memory per block and
    residency for these widths, fp32 and bf16."""
    from repro_torch.kernels.paged_attention import launch_shape
    g, hd = q.shape[1] // kp.shape[2], q.shape[2]
    for dt in (torch.float32, torch.bfloat16):
        ls = launch_shape(dt, hd, g, q.device)
        print(f"  paged_attention.cu instance ({str(dt)[6:]}, hd {hd}, G "
              f"{g}): {ls['head_groups']} head group(s) per (row, kv head), "
              f"cluster {ls['cluster']} blocks x {ls['warps']} warps, "
              f"{ls['stages']} cp.async stages of "
              f"{ls['positions_per_stage']} positions per warp, "
              f"{ls['smem_bytes']} B shared memory per block, "
              f"{ls['blocks_per_sm']} blocks per SM, {ls['clusters']} "
              f"clusters resident", flush=True)


def kernels_phase(dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill import packed_prefill_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention

    rng = np.random.default_rng(0)
    results = {}
    # main-path shapes of the serve phase: batch and table widths are the
    # engine's buckets (seg_bucket(12) = 16 rows, table_bucket(33) = 48
    # pages), lengths ragged from 1 to a full table
    cases = {
        "qwen1.5-0.5b": dict(
            decode=(16, 16, 16, 64, 16, 48,
                    [1, 2, 15, 16, 17, 64, 100, 200, 333, 400, 512, 513,
                     600, 700, 767, 768]),
            prefill=(8, 512, 512, 16, 16, 64,
                     [0, 0, 64, 0, 0, 0, 0, 0])),
        "qwen2-7b (GQA)": dict(
            decode=(16, 28, 4, 128, 16, 48,
                    [1, 5, 16, 17, 90, 128, 257, 300, 411, 500, 512, 600,
                     640, 700, 767, 768]),
            prefill=(4, 256, 512, 28, 4, 128, [0, 256, 100, 64])),
    }
    results["copy"] = copy_kernels(rng, dev)
    for label, c in cases.items():
        print(f"  -- {label}", flush=True)
        d_args = decode_case(rng, *c["decode"], dev)
        p_args = prefill_case(rng, *c["prefill"], dev)
        q, kc, vc, ctx = p_args
        rows = real_rows(ctx, q.shape[1], kc.shape[1])
        print_launch_shape(d_args[0], d_args[1])
        d_err = compare("paged_decode_attention",
                        paged_decode_attention(*d_args),
                        ref.paged_decode_attention_ref(*d_args))
        p_err = compare("packed_prefill_attention",
                        packed_prefill_attention(*p_args),
                        ref.packed_prefill_attention_ref(*p_args), rows)
        sdpa = sdpa_inputs(*p_args)
        sdpa_out = F.scaled_dot_product_attention(
            sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3], enable_gqa=True)
        torch.cuda.synchronize()
        lib_err = float((rows(sdpa_out.transpose(1, 2)) - rows(
            ref.packed_prefill_attention_ref(*p_args))).abs().max())
        print(f"  scaled_dot_product_attention (yardstick, not checked): "
              f"max_abs_err {lib_err:.3e}", flush=True)
        # (plain, kernel, kernel, plain) turns; report the means
        d_k, d_p = turns(lambda: paged_decode_attention(*d_args),
                         lambda: ref.paged_decode_attention_ref(*d_args))
        p_k, p_p = turns(lambda: packed_prefill_attention(*p_args),
                         lambda: ref.packed_prefill_attention_ref(*p_args))
        p_l = time_ms(lambda: F.scaled_dot_product_attention(
            sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3], enable_gqa=True))
        d_warm = time_ms(lambda: paged_decode_attention(*d_args),
                         cold_l2=False)
        p_warm = time_ms(lambda: packed_prefill_attention(*p_args),
                         cold_l2=False)
        d_bound = decode_bound(d_args[0], d_args[1], d_args[3], d_args[4])
        p_bound = prefill_bound(q, kc, ctx)
        results[label] = {
            "paged_decode_attention": dict(
                max_abs_err=d_err, ms=float(np.mean(d_k)), warm_l2_ms=d_warm,
                plain_ms=float(np.mean(d_p)), library_ms=None,
                bound_ms=d_bound[0], bound_by=d_bound[1],
                shape="q %s pages %s lens %s" % (
                    tuple(d_args[0].shape), tuple(d_args[1].shape),
                    c["decode"][-1])),
            "packed_prefill_attention": dict(
                max_abs_err=p_err, ms=float(np.mean(p_k)), warm_l2_ms=p_warm,
                plain_ms=float(np.mean(p_p)), library_ms=p_l,
                bound_ms=p_bound[0], bound_by=p_bound[1],
                shape="q %s kv %s ctx %s" % (
                    tuple(q.shape), tuple(kc.shape), c["prefill"][-1])),
        }
        results[label]["packed_prefill_attention (bf16)"] = bf16_prefill(
            "packed_prefill_attention", packed_prefill_attention,
            ref.packed_prefill_attention_ref,
            [a.bfloat16() if a.is_floating_point() else a for a in p_args],
            ctx, rows)
        # the bf16 instance at the fp32 row's shapes (printed; the JSON
        # line keeps the fp32 rows)
        results[label]["paged_decode_attention (bf16)"] = measure(
            "paged_decode_attention (bf16)", paged_decode_attention,
            ref.paged_decode_attention_ref,
            [a.bfloat16() if a.is_floating_point() else a for a in d_args],
            lambda q, kp, vp, bt, ln: decode_bound(q, kp, bt, ln))
        if label == "qwen1.5-0.5b":
            results[label].update(slice3_kernels(rng, dev, p_args))
        for name, r in results[label].items():
            print(f"  {name}: kernel {r['ms']:.4f} ms (warm L2 "
                  f"{r['warm_l2_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                  f"[{r['shape']}]", flush=True)
    results["slice 6"] = slice6_kernels(rng, dev)
    return results


def verify_case(rng, n_seg, depth, h, hkv, hd, page, n_pages, maxp, base,
                dev):
    """The engine's verify launch: n_seg requests of depth + 1 rows each
    (row j at length base + j + 1), rows padded to seg_bucket, the compact
    table to seg_bucket(n_seg + 1) rows (padding rows point at a zero
    row with length 0), pages one layer plane of the pool."""
    from repro_torch.serving.model_exec import seg_bucket
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    n_rows = n_seg * (depth + 1)
    r_b, s_b = seg_bucket(n_rows), seg_bucket(n_seg + 1)
    bt = np.zeros((s_b, maxp), np.int32)
    bt[:n_seg] = rng.integers(1, n_pages, (n_seg, maxp))
    seg = np.full(r_b, n_seg, np.int32)
    seg[:n_rows] = np.repeat(np.arange(n_seg), depth + 1)
    lens = np.zeros(r_b, np.int32)
    lens[:n_rows] = (np.repeat(base, depth + 1)
                     + np.tile(np.arange(depth + 1), n_seg) + 1)
    return ((t(rng.standard_normal((r_b, h, hd))),
             t(rng.standard_normal((n_pages, page, hkv, hd))),
             t(rng.standard_normal((n_pages, page, hkv, hd))),
             t(bt, torch.int32), t(lens, torch.int32)),
            torch.as_tensor(seg))


def verify_bound(q, kp, bt, lens, seg) -> tuple[float, str]:
    """Least time for a verify launch: each request's live K/V (its
    longest row) read once, q, the tables, lengths and row map read once,
    the output written once; 4 flops per (query head, position a row
    sees, dim)."""
    r, h, hd = q.shape
    hkv = kp.shape[2]
    longest: dict = {}
    for s_, n in zip(seg.tolist(), lens.tolist()):
        longest[s_] = max(longest.get(s_, 0), n)
    live = sum(longest.values())
    nbytes = (2 * live * hkv * hd + 2 * r * h * hd) * q.element_size() \
        + bt.numel() * 4 + 2 * lens.numel() * 4
    flops = 4 * int(lens.sum()) * h * hd
    return bound(nbytes, flops)


def slice3_kernels(rng, dev, p_args) -> dict:
    """Kernels 3 and 4 at the main path's shapes (Qwen1.5-0.5B): fp32 and
    bf16 against their plain versions; the JAX contracts bitwise on the
    card (chunked per request = packed per segment at ctx + Sq, each
    verify row = the decode row on its gathered table); times."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill import (
        chunked_prefill_attention, packed_prefill_attention)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.spec_verify import packed_verify_attention

    print("  -- chunked prefill and packed verify (Qwen1.5-0.5B)",
          flush=True)
    # a draft's prompt ingest: bucket(n) = 512 queries of a fresh prompt
    # against the 1024-position staging span; cache_lens include the chunk
    c_args = prefill_case(rng, 1, 512, 1024, 16, 16, 64, [512], dev)
    c_err = compare("chunked_prefill_attention",
                    chunked_prefill_attention(*c_args),
                    ref.chunked_prefill_attention_ref(*c_args))
    tail = prefill_case(rng, 1, 16, 1024, 16, 16, 64, [336], dev)
    compare("chunked_prefill_attention (16-token chunk after 320)",
            chunked_prefill_attention(*tail),
            ref.chunked_prefill_attention_ref(*tail))
    c_bf = [a.bfloat16() if a.is_floating_point() else a for a in c_args]
    compare("chunked_prefill_attention (bf16)",
            chunked_prefill_attention(*c_bf),
            ref.chunked_prefill_attention_ref(*c_bf))
    # 16 requests at depth 2 (48 rows), a 48-page table bucket
    base = [1, 2, 15, 16, 17, 64, 100, 200, 333, 400, 512, 513, 600, 700,
            764, 765]
    v_args, seg = verify_case(rng, 16, 2, 16, 16, 64, 16, 160, 48, base,
                              dev)
    v_err = compare("packed_verify_attention",
                    packed_verify_attention(*v_args, seg),
                    ref.packed_verify_attention_ref(*v_args, seg))
    v_bf = [a.bfloat16() if a.is_floating_point() else a for a in v_args]
    for label, args in (("fp32", v_args), ("bf16", v_bf)):
        q, kp, vp, bt, ln = args
        bitwise(f"packed_verify_attention rows = paged_decode_attention on "
                f"tables[row_seg] ({label})",
                packed_verify_attention(*args, seg),
                paged_decode_attention(q, kp, vp, bt[seg.to(dev).long()]
                                       .contiguous(), ln))
    for label, args in (("fp32", p_args), ("bf16", [
            a.bfloat16() if a.is_floating_point() else a for a in p_args])):
        q, kc, vc, ctx = args
        packed = packed_prefill_attention(*args)
        one = torch.stack([chunked_prefill_attention(
            q[i:i + 1], kc[i:i + 1], vc[i:i + 1], ctx[i:i + 1] + q.shape[1])[0]
            for i in range(q.shape[0])])
        bitwise(f"chunked_prefill_attention per request = "
                f"packed_prefill_attention per segment ({label}, "
                f"{q.shape[0]} segments)", one, packed)

    q, kc, vc, cl = c_args
    c_bf16 = bf16_prefill("chunked_prefill_attention",
                          chunked_prefill_attention,
                          ref.chunked_prefill_attention_ref, c_bf,
                          cl - q.shape[1])
    sdpa = sdpa_inputs(q, kc, vc, cl - q.shape[1])
    c_k, c_p = turns(lambda: chunked_prefill_attention(*c_args),
                     lambda: ref.chunked_prefill_attention_ref(*c_args))
    v_k, v_p = turns(lambda: packed_verify_attention(*v_args, seg),
                     lambda: ref.packed_verify_attention_ref(*v_args, seg))
    c_bound = prefill_bound(q, kc, cl - q.shape[1])
    v_bound = verify_bound(v_args[0], v_args[1], v_args[3], v_args[4], seg)
    return {
        # library: one SDPA call with the offset causal mask computes the
        # same function (never called by the port)
        "chunked_prefill_attention": dict(
            max_abs_err=c_err, ms=float(np.mean(c_k)),
            warm_l2_ms=time_ms(lambda: chunked_prefill_attention(*c_args),
                               cold_l2=False),
            plain_ms=float(np.mean(c_p)), library_ms=time_ms(
                lambda: F.scaled_dot_product_attention(
                    sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3],
                    enable_gqa=True)),
            bound_ms=c_bound[0], bound_by=c_bound[1],
            shape=f"q {tuple(q.shape)} kv {tuple(kc.shape)} cache_lens "
                  f"{cl.tolist()}"),
        "chunked_prefill_attention (bf16)": c_bf16,
        "packed_verify_attention (bf16)": measure(
            "packed_verify_attention (bf16)",
            lambda *a: packed_verify_attention(*a, seg),
            lambda *a: ref.packed_verify_attention_ref(*a, seg), v_bf,
            lambda q, kp, vp, bt, ln: verify_bound(q, kp, bt, ln, seg)),
        # library: none; no PyTorch call reads a paged pool through a
        # block table (as for paged_decode_attention)
        "packed_verify_attention": dict(
            max_abs_err=v_err, ms=float(np.mean(v_k)),
            warm_l2_ms=time_ms(lambda: packed_verify_attention(*v_args, seg),
                               cold_l2=False),
            plain_ms=float(np.mean(v_p)), library_ms=None,
            bound_ms=v_bound[0], bound_by=v_bound[1],
            shape=f"q {tuple(v_args[0].shape)} pages "
                  f"{tuple(v_args[1].shape)} tables {tuple(v_args[3].shape)}"
                  f", 16 requests x 3 rows, l_kv {base}"),
    }


def slice6_kernels(rng, dev) -> dict:
    """The shapes the attention kernels took on last: ChatGLM3-6B's G 16 at
    hd 128 (decode and verify in two head groups of 8) and head_dim 8 (the
    dense SMOKE configs), each at the serve phase's decode and verify
    shapes and at prefill shapes, fp32 and bf16: against the plain versions
    (fp32 2e-5, bf16 2e-2), verify = decode and chunked = packed bitwise,
    and at G 16 a head's bits the same in either head group.  Timed beside
    the plain versions, SDPA for prefill, and their bounds (printed, not
    in the JSON line)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill import (
        chunked_prefill_attention, packed_prefill_attention)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.spec_verify import packed_verify_attention

    def sdpa(q, kc, vc, ctx):
        a = sdpa_inputs(q, kc, vc, ctx)
        return lambda: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3], enable_gqa=True)

    lens = [1, 2, 15, 16, 17, 64, 100, 200, 333, 400, 512, 513, 600, 700,
            767, 768]
    out = {}
    for label, (h, hkv, hd) in {"chatglm3-6b (G 16, hd 128)": (32, 2, 128),
                                "hd 8": (8, 2, 8)}.items():
        print(f"  -- {label}", flush=True)
        d_f32 = decode_case(rng, 16, h, hkv, hd, 16, 48, lens, dev)
        print_launch_shape(d_f32[0], d_f32[1])
        v_f32, seg = verify_case(rng, 16, 2, h, hkv, hd, 16, 160, 48,
                                 lens[:-2] + [764, 765], dev)
        p_f32 = prefill_case(rng, 4, 256, 512, h, hkv, hd, [0, 256, 100, 64],
                             dev)
        c_f32 = prefill_case(rng, 1, 512, 1024, h, hkv, hd, [512], dev)
        for dt in ("fp32", "bf16"):
            cast = (lambda a: a) if dt == "fp32" else (lambda a: [
                t.bfloat16() if t.is_floating_point() else t for t in a])
            d, v, p, c = cast(d_f32), cast(v_f32), cast(p_f32), cast(c_f32)
            out[f"{label} paged_decode_attention ({dt})"] = measure(
                f"paged_decode_attention ({dt})", paged_decode_attention,
                ref.paged_decode_attention_ref, d,
                lambda q, kp, vp, bt, ln: decode_bound(q, kp, bt, ln))
            out[f"{label} packed_verify_attention ({dt})"] = measure(
                f"packed_verify_attention ({dt})",
                lambda *a: packed_verify_attention(*a, seg),
                lambda *a: ref.packed_verify_attention_ref(*a, seg), v,
                lambda q, kp, vp, bt, ln: verify_bound(q, kp, bt, ln, seg))
            q, kp, vp, bt, ln = v
            bitwise(f"packed_verify_attention rows = paged_decode_attention "
                    f"on tables[row_seg] ({dt})",
                    packed_verify_attention(*v, seg),
                    paged_decode_attention(q, kp, vp, bt[seg.to(dev).long()]
                                           .contiguous(), ln))
            q, kc, vc, ctx = p
            out[f"{label} packed_prefill_attention ({dt})"] = measure(
                f"packed_prefill_attention ({dt})", packed_prefill_attention,
                ref.packed_prefill_attention_ref, p,
                lambda q, kc, vc, ctx: prefill_bound(q, kc, ctx),
                rows=real_rows(ctx, q.shape[1], kc.shape[1]),
                library=sdpa(*p))
            one = torch.stack([chunked_prefill_attention(
                q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                ctx[i:i + 1] + q.shape[1])[0] for i in range(q.shape[0])])
            bitwise(f"chunked_prefill_attention per request = "
                    f"packed_prefill_attention per segment ({dt})", one,
                    packed_prefill_attention(*p))
            q, kc, vc, cl = c
            out[f"{label} chunked_prefill_attention ({dt})"] = measure(
                f"chunked_prefill_attention ({dt})",
                chunked_prefill_attention, ref.chunked_prefill_attention_ref,
                c, lambda q, kc, vc, cl: prefill_bound(q, kc, cl - q.shape[1]),
                library=sdpa(q, kc, vc, cl - q.shape[1]))
            if h // hkv > 8:
                # queries of the two head groups swapped: outputs swapped
                q, kp, vp, bt, ln = d
                g = h // hkv
                perm = torch.arange(h, device=dev).reshape(
                    hkv, 2, g // 2).flip(1).reshape(-1)
                bitwise(f"paged_decode_attention with the head groups' "
                        f"queries swapped = its output swapped ({dt})",
                        paged_decode_attention(q[:, perm].contiguous(), kp,
                                               vp, bt, ln),
                        paged_decode_attention(q, kp, vp, bt, ln)[:, perm])
    for name, r in out.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms (warm L2 "
              f"{r['warm_l2_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{r['shape']}]", flush=True)
    return out


def exact(name: str, got, want) -> float:
    """Bitwise comparison (the copy kernels' contract)."""
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            fail(f"{name} is not bitwise equal to its plain version")
    print(f"  {name}: bitwise equal to its plain version", flush=True)
    return 0.0


def copy_kernels(rng, dev) -> dict:
    """The kv_quant pair on one demoted group of 8 Qwen1.5-0.5B blocks
    (fp32 and bf16 input, with a zero plane and half-way values), and
    block_gather in its JAX form (planes = 1) and in the pool's form
    (planes = L*2, the offload snapshot)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import block_gather
    from repro_torch.kernels.kv_quant import (kv_block_dequantize,
                                              kv_block_quantize)

    print("  -- copy kernels (Qwen1.5-0.5B blocks)", flush=True)
    n, lyr, bs, hkv, hd, nblk = 8, 24, 16, 16, 64, 160
    x = torch.as_tensor(rng.standard_normal((n, lyr, 2, bs, hkv, hd)),
                        dtype=torch.float32, device=dev)
    x[0, 3, 1] = 0.0                                  # a zero plane
    x[1, 0, 0] = (torch.arange(bs * hkv * hd, device=dev).reshape(
        bs, hkv, hd) - 2000) * 0.5                    # exact half-way steps
    q_err = exact("kv_block_quantize", kv_block_quantize(x),
                  ref.kv_block_quantize_ref(x))
    exact("kv_block_quantize (bf16 in)", kv_block_quantize(x.bfloat16()),
          ref.kv_block_quantize_ref(x.bfloat16()))
    # one demoted group of 8 ChatGLM3-6B blocks: 4096 values a plane
    xg = torch.as_tensor(rng.standard_normal((n, 28, 2, bs, 2, 128)),
                         dtype=torch.float32, device=dev)
    xg[0, 3, 1] = 0.0
    xg[1, 0, 0] = (torch.arange(bs * 2 * 128, device=dev).reshape(
        bs, 2, 128) - 2000) * 0.5
    exact("kv_block_quantize (ChatGLM3-6B blocks)", kv_block_quantize(xg),
          ref.kv_block_quantize_ref(xg))
    exact("kv_block_quantize (ChatGLM3-6B blocks, bf16 in)",
          kv_block_quantize(xg.bfloat16()),
          ref.kv_block_quantize_ref(xg.bfloat16()))
    vals, scales = ref.kv_block_quantize_ref(x)
    d_err = exact("kv_block_dequantize", kv_block_dequantize(vals, scales),
                  ref.kv_block_dequantize_ref(vals, scales))
    pool1 = torch.as_tensor(rng.standard_normal((nblk, bs, hkv, hd)),
                            dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.permutation(nblk)[:n], dtype=torch.int32)
    idx_dev = idx.to(dev)
    g_err = exact("block_gather (planes 1)", block_gather(pool1, idx),
                  ref.block_gather_ref(pool1, idx_dev))
    kv = torch.as_tensor(rng.standard_normal((lyr, 2, nblk, bs, hkv, hd)),
                         dtype=torch.float32, device=dev)
    exact("block_gather (planes 48)", block_gather(kv, idx, 2),
          ref.block_gather_ref(kv, idx_dev, 2).contiguous())

    lib = torch.mul(vals, scales[..., None, None, None])
    torch.cuda.synchronize()
    print("  torch.mul(vals, scales) (yardstick for kv_block_dequantize, not "
          f"checked): {lib.dtype}, bitwise equal to the plain version: "
          f"{torch.equal(lib, ref.kv_block_dequantize_ref(vals, scales))}",
          flush=True)
    r, e = n * lyr * 2, bs * hkv * hd
    q_k, q_p = turns(lambda: kv_block_quantize(x),
                     lambda: ref.kv_block_quantize_ref(x))
    qg_k, qg_p = turns(lambda: kv_block_quantize(xg),
                       lambda: ref.kv_block_quantize_ref(xg))
    # the tiered pass (b) quantizes groups of 4 to 32 Qwen1.5-0.5B blocks,
    # half of them 25 or more (its printed histogram, NVIDIA H100 80GB
    # HBM3 @ 700 W): 26 blocks, 1248 plane rows
    x26 = torch.as_tensor(rng.standard_normal((26, lyr, 2, bs, hkv, hd)),
                          dtype=torch.float32, device=dev)
    exact("kv_block_quantize (26 blocks)", kv_block_quantize(x26),
          ref.kv_block_quantize_ref(x26))
    q26_k, q26_p = turns(lambda: kv_block_quantize(x26),
                         lambda: ref.kv_block_quantize_ref(x26))
    d_k, d_p = turns(lambda: kv_block_dequantize(vals, scales),
                     lambda: ref.kv_block_dequantize_ref(vals, scales))
    g_k, g_p = turns(lambda: block_gather(kv, idx, 2),
                     lambda: ref.block_gather_ref(kv, idx_dev, 2)
                     .contiguous())
    g1_k, g1_p = turns(lambda: block_gather(pool1, idx),
                       lambda: ref.block_gather_ref(pool1, idx_dev))
    row_bytes = e * 4
    out = {
        # library: none; no single PyTorch call computes the per-plane
        # absmax scales and the int8 values together
        "kv_block_quantize": dict(
            max_abs_err=q_err, ms=float(np.mean(q_k)), plain_ms=float(
                np.mean(q_p)), library_ms=None,
            warm_l2_ms=time_ms(lambda: kv_block_quantize(x), cold_l2=False),
            bound=bound(r * e * (4 + 1) + 4 * r, 0),
            shape=f"blocks {tuple(x.shape)} fp32"),
        "kv_block_quantize (26 blocks)": dict(
            max_abs_err=0.0, ms=float(np.mean(q26_k)),
            plain_ms=float(np.mean(q26_p)), library_ms=None,
            warm_l2_ms=time_ms(lambda: kv_block_quantize(x26),
                               cold_l2=False),
            bound=bound(x26.numel() * (4 + 1) + 4 * 26 * lyr * 2, 0),
            shape=f"blocks {tuple(x26.shape)} fp32"),
        "kv_block_quantize (chatglm3-6b)": dict(
            max_abs_err=0.0, ms=float(np.mean(qg_k)),
            plain_ms=float(np.mean(qg_p)), library_ms=None,
            warm_l2_ms=time_ms(lambda: kv_block_quantize(xg), cold_l2=False),
            bound=bound(xg.numel() * (4 + 1) + 4 * n * 28 * 2, 0),
            shape=f"blocks {tuple(xg.shape)} fp32"),
        # library: one broadcast multiply; int8 x fp32 promotes to fp32
        "kv_block_dequantize": dict(
            max_abs_err=d_err, ms=float(np.mean(d_k)), plain_ms=float(
                np.mean(d_p)), library_ms=time_ms(
                    lambda: torch.mul(vals, scales[..., None, None, None])),
            warm_l2_ms=time_ms(lambda: kv_block_dequantize(vals, scales),
                               cold_l2=False),
            bound=bound(r * e * (1 + 4) + 4 * r, 0),
            shape=f"vals {tuple(vals.shape)} int8"),
        # the offload snapshot's form; library: index_select along the
        # block axis moves the same bytes (block axis left in place)
        "block_gather": dict(
            max_abs_err=g_err, ms=float(np.mean(g_k)), plain_ms=float(
                np.mean(g_p)),
            library_ms=time_ms(lambda: torch.index_select(kv, 2, idx_dev)),
            warm_l2_ms=time_ms(lambda: block_gather(kv, idx, 2),
                               cold_l2=False),
            bound=bound(2 * n * lyr * 2 * row_bytes, 0),
            shape=f"pool {tuple(kv.shape)} block_dim 2, n {n}"),
        "block_gather (planes 1)": dict(
            max_abs_err=g_err, ms=float(np.mean(g1_k)), plain_ms=float(
                np.mean(g1_p)),
            library_ms=time_ms(lambda: torch.index_select(pool1, 0,
                                                          idx_dev)),
            warm_l2_ms=time_ms(lambda: block_gather(pool1, idx),
                               cold_l2=False),
            bound=bound(2 * n * row_bytes, 0),
            shape=f"pool {tuple(pool1.shape)}, n {n}"),
    }
    for name, res in out.items():
        res["bound_ms"], res["bound_by"] = res.pop("bound")
        print(f"  {name}: kernel {res['ms']:.4f} ms (warm L2 "
              f"{res['warm_l2_ms']:.4f} ms), plain {res['plain_ms']:.4f} "
              f"ms, library {res['library_ms']} ms, bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}) "
              f"[{res['shape']}]", flush=True)
    return out


# --------------------------------------------------------------------------
# serve and tiered phases
# --------------------------------------------------------------------------

_GREEDY: dict = {}


def check_streams(res, label: str) -> None:
    """Every stream against greedy decoding by the port's own forward
    (one greedy run per distinct prompt)."""
    from repro_torch.models.model import forward

    cfg, params, outputs = res.cfg, res.params, res.outputs
    t0 = time.monotonic()
    for r, prompt in res.requests:
        got = outputs[r.rid]
        key = (cfg.name, prompt.tobytes(), r.output_len)
        if key in _GREEDY:
            if got != _GREEDY[key]:
                fail(f"{label}: rid {r.rid} (priority {r.priority}) != "
                     "greedy forward")
            continue
        cur = torch.as_tensor(prompt, dtype=torch.long,
                              device=params["embed"].device)[None]
        for pos in range(r.output_len):
            logits = forward(cfg, params, cur, last_only=True)[0, -1]
            want = int(logits.argmax())
            if got[pos] != want:
                top2 = torch.topk(logits, 2).values
                fail(f"{label}: rid {r.rid} (priority {r.priority}) "
                     f"diverges at output position {pos}: engine "
                     f"{got[pos]}, greedy forward {want}, top-2 logit "
                     f"margin {float(top2[0] - top2[1]):.3e}")
            cur = torch.cat([cur, cur.new_tensor([[want]])], dim=1)
        _GREEDY[key] = list(got)
    print(f"  all {len(res.requests)} streams equal greedy forward token "
          f"for token ({time.monotonic() - t0:.1f} s)", flush=True)


def check_launches(res, counts: dict, label: str) -> None:
    """Each attention kernel launched n_layers x the model calls of its
    kind: the target's decode launches (decode, or verify when
    speculating), packed prefill calls and per-request prefill_chunk
    calls, and the draft's decode rounds (its syncs) and prompt ingests
    (its other launches); each copy kernel exactly as often as the pool,
    the tier store and the transfer worker called it; one host sync per
    sampling launch: target decode launches, packed prefill calls, draft
    decode rounds and, on the per-request path, prompt completions (one
    per request).  A fleet's replicas (killed ones too) are summed."""
    n_layers = res.cfg.n_layers
    want = dict.fromkeys(counts, 0)
    syncs = host_syncs = failures = 0
    for eng in res.replicas:
        st, pool, draft = eng.stats, eng.pool, eng.draft
        d_layers = draft.cfg.n_layers if draft else 0
        d_rounds = draft.syncs if draft else 0
        d_ingests = draft.launches - draft.syncs if draft else 0
        for name, n in {
                "paged_decode_attention": (0 if draft else n_layers
                                           * st.decode_launches)
                + d_layers * d_rounds,
                "packed_verify_attention": n_layers * st.decode_launches
                if draft else 0,
                "packed_prefill_attention": n_layers
                * st.packed_prefill_calls,
                "chunked_prefill_attention": n_layers
                * st.prefill_chunk_calls + d_layers * d_ingests,
                "block_gather": pool.gather_calls,
                "kv_block_quantize": pool.quantize_calls
                + pool.tier.quantize_calls,
                "kv_block_dequantize": pool.dequantize_calls
                + pool.tier.dequantize_calls
                + (eng.worker.dequantize_calls if eng.worker else 0),
        }.items():
            want[name] += n
        completions = 0 if eng.packed_prefill else len(res.requests)
        syncs += (st.decode_launches + st.packed_prefill_calls + d_rounds
                  + completions)
        host_syncs += st.host_syncs
        failures += st.transfer_failures
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{label}: {name} launched {counts[name]} times, its "
                 f"callers counted {n}")
    if host_syncs != syncs:
        fail(f"{label}: host syncs {host_syncs} != decode launches + "
             f"packed prefill calls + draft rounds + prompt completions "
             f"({syncs})")
    if failures:
        fail(f"{label}: {failures} background copies failed")


def report(res, counts: dict, label: str, card: str) -> None:
    summary = res.summary()
    engines = res.replicas
    print(f"  [{card}] {label}: served {summary['requests']} requests in "
          f"{summary['wall_s']:.3f} s: {summary['tokens_per_s']:.1f} "
          f"tokens/s (prefill + output), "
          f"{summary['output_tokens_per_s']:.1f} output tokens/s",
          flush=True)
    for p in (1, 2, 3):
        print(f"  [{card}] priority {p}: TTFT p50 "
              f"{summary[f'ttft_p50_s_prio{p}']:.4f} s, TPOT p50 "
              f"{summary[f'tpot_p50_s_prio{p}']:.4f} s", flush=True)
    keys = ("tdg_ratio", "evictions", "reload_blocks", "cache_hit_tokens",
            "cow_forks", "iterations", "decode_launches",
            "packed_prefill_calls", "host_syncs", "offload_blocks",
            "staged_hits", "staged_misses", "transfer_failures",
            "t_block_measured", "host_bytes", "spill_blocks", "cold_blocks",
            "demoted_blocks", "cold_reload_blocks", "prefill_chunk_calls",
            "spec_proposed", "spec_accepted", "spec_rejected",
            "draft_launches", "spec_depth_hist")
    wait = sum(e.stats.transfer_wait_s for e in engines)
    print(f"  [{card}] " + ", ".join(f"{k} {summary[k]}" for k in keys)
          + f", transfer_wait_s {wait:.4f}", flush=True)
    cache = [e.cache.stats for e in engines]
    print(f"  [{card}] cache: " + ", ".join(
        f"{what} {sum(getattr(cs, key) for cs in cache)}" for what, key in (
            ("spilled", "spilled_blocks"), ("restored", "restored_blocks"),
            ("staged restores", "staged_restores"),
            ("re-adopted", "readopted_blocks"))), flush=True)
    print(f"  launch counts {counts}", flush=True)

def serve_phase(card: str):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    fresh_peak()
    ops.reset_launch_counts()
    res = serve.main(["--arch", "qwen1_5_0_5b", "--device", "cuda",
                      "--seed", "0"])
    counts = ops.launch_counts()
    st = res.engine.stats
    peak = torch.cuda.max_memory_allocated()
    report(res, counts, "serve", card)
    print(f"  max_memory_allocated {peak / 2**30:.3f} GiB", flush=True)
    if st.evictions < 1:
        fail("the serve phase had no eviction")
    if st.cache_hit_tokens < 1:
        fail("the serve phase had no prefix-cache hit")
    if st.offload_blocks < 1 or st.t_block_measured <= 0:
        fail("no background D2H mirror landed with a measured copy time")
    check_launches(res, counts, "serve")
    check_streams(res, "serve")
    res.engine.kill()

    print("  -- lanes off (synchronous copies on the engine thread)",
          flush=True)
    ops.reset_launch_counts()
    off = serve.main(["--arch", "qwen1_5_0_5b", "--device", "cuda",
                      "--seed", "0", "--no-overlap"])
    counts_off = ops.launch_counts()
    report(off, counts_off, "serve, lanes off", card)
    if off.engine.worker is not None or off.engine.stats.offload_blocks:
        fail("serve, lanes off: a background lane ran")
    if off.engine.stats.evictions < 1:
        fail("serve, lanes off: no eviction")
    check_launches(off, counts_off, "serve, lanes off")
    check_streams(off, "serve, lanes off")
    off.engine.kill()
    return counts, counts_off, st.decode_launches


class Refutations:
    """Records each verify outcome with a refuted proposal (request,
    output index of the refuted token) by wrapping ``DraftRunner.observe``
    on its class for one run."""

    def __init__(self):
        from repro_torch.serving.spec import DraftRunner
        self.cls, self.orig, self.seen = DraftRunner, DraftRunner.observe, []

    def __enter__(self):
        orig, seen = self.orig, self.seen

        def observe(runner, rid, depth, accepted):
            tgt = runner._pending.get(rid)
            if tgt is not None and accepted < depth:
                seen.append((rid, tgt + 1 + accepted))
            return orig(runner, rid, depth, accepted)

        self.cls.observe = observe
        return self

    def __exit__(self, *exc):
        self.cls.observe = self.orig


def refuted_margins(res, seen) -> list:
    """Greedy forward's top-2 logit margin at each refuted position: a
    same-weights draft is refuted only where the two forwards' argmax
    differ, which a small margin explains."""
    from repro_torch.models.model import forward
    prompts = {r.rid: p for r, p in res.requests}
    out = []
    for rid, pos in seen:
        prompt = prompts[rid]
        seq = np.concatenate([prompt, res.engine.outputs[rid]])[:pos]
        logits = forward(res.cfg, res.params, torch.as_tensor(
            seq, dtype=torch.long, device=res.engine.device)[None],
            last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        out.append((rid, pos - len(prompt), float(top2[0] - top2[1])))
    return out


def spec_phase(card: str, plain_decode_launches: int):
    """Speculative decoding (``--spec-k 2``) on the serve traffic, with a
    draft of the target's own weights and with one from another seed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    runs = {}
    for draft in ("same", "other"):
        label = f"spec, {draft} draft"
        print(f"  -- {label}", flush=True)
        ops.reset_launch_counts()
        with Refutations() as refuted:
            res = serve.main(["--arch", "qwen1_5_0_5b", "--device", "cuda",
                              "--seed", "0", "--spec-k", "2", "--draft",
                              draft])
        counts = ops.launch_counts()
        report(res, counts, label, card)
        st, drf = res.engine.stats, res.engine.draft
        print(f"  [{card}] {label}: proposed {st.spec_proposed}, accepted "
              f"{st.spec_accepted}, rejected {st.spec_rejected}, depth "
              f"histogram {dict(sorted(st.spec_depth_hist.items()))}, target "
              f"decode launches {st.decode_launches} (spec off: "
              f"{plain_decode_launches}), draft launches {drf.launches} "
              f"({drf.syncs} decode rounds)", flush=True)
        if st.spec_proposed <= 0:
            fail(f"{label}: nothing was proposed")
        if st.spec_proposed != st.spec_accepted + st.spec_rejected:
            fail(f"{label}: proposed != accepted + rejected")
        if draft == "same":
            for rid, idx, margin in refuted_margins(res, refuted.seen):
                print(f"  refuted: rid {rid} output {idx}: greedy top-2 "
                      f"logit margin {margin:.3e}", flush=True)
            if st.spec_accepted < 0.9 * st.spec_proposed:
                fail(f"{label}: accepted {st.spec_accepted} of "
                     f"{st.spec_proposed} proposals (< 90 %)")
            if st.decode_launches >= plain_decode_launches:
                fail(f"{label}: {st.decode_launches} target decode launches,"
                     f" not fewer than spec off ({plain_decode_launches})")
        elif st.spec_rejected <= 0:
            fail(f"{label}: an other-seed draft had nothing rejected")
        check_launches(res, counts, label)
        check_streams(res, label)
        res.engine.kill()
        runs[draft] = counts
    return runs["same"], runs["other"]


def per_request_phase(card: str):
    """The reference's fallback paths (``--per-request``): one
    prefill_chunk call per prefill chunk and the logits decode."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    ops.reset_launch_counts()
    res = serve.main(["--arch", "qwen1_5_0_5b", "--device", "cuda",
                      "--seed", "0", "--per-request"])
    counts = ops.launch_counts()
    report(res, counts, "per-request", card)
    st = res.engine.stats
    if st.prefill_chunk_calls < 1 or st.packed_prefill_calls:
        fail("per-request: prefill did not run per request")
    check_launches(res, counts, "per-request")
    check_streams(res, "per-request")
    res.engine.kill()
    return counts


def glm_phase(card: str):
    """``launch/serve.py`` at ChatGLM3-6B's full published width (28
    layers, d_model 4096, H 32 / Hkv 2 so G 16, hd 128, d_ff 13696, vocab
    65024, half-rotary RoPE, QKV bias; fp32 weights from ``init_params``,
    nothing cut) on the serve traffic: every stream equals greedy forward
    under the serve phase's launch-count and host-sync gates."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    fresh_peak()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = serve.main(["--arch", "chatglm3_6b", "--device", "cuda", "--seed",
                      "0"])
    counts = ops.launch_counts()
    t_serve = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    st = res.engine.stats
    report(res, counts, "glm", card)
    if st.evictions < 1:
        fail("glm: no eviction")
    check_launches(res, counts, "glm")
    check_streams(res, "glm")
    print(f"  [{card}] glm: init + serve {t_serve:.1f} s (serve wall "
          f"{res.wall_s:.3f} s), phase {time.monotonic() - t0:.1f} s with "
          f"the greedy check; max_memory_allocated {peak / 2**30:.2f} GiB "
          f"through the serve; "
          f"{st.decode_launches} decode launches, "
          f"{st.packed_prefill_calls} packed prefill calls "
          f"(paged_decode_attention x{counts['paged_decode_attention']}, "
          f"packed_prefill_attention x{counts['packed_prefill_attention']})",
          flush=True)
    res.engine.kill()
    return counts


# |x - dequant(quant(x))| <= scale / 2 exactly; in fp32 three roundings of
# values up to 127 steps (inv = 1 / scale, x * inv, q * scale) add at most
# 3 * 127 * 2^-24 of a step
QUANT_BOUND_STEPS = 0.5 + 3 * 127 * 2.0 ** -24


class QuantAudit:
    """Wraps ``ops.kv_block_quantize`` for one run: checks on the card
    that every quantized plane comes back within ``QUANT_BOUND_STEPS``
    of its scale, and counts the calls by their number of blocks."""

    def __init__(self, ops):
        self.ops, self.inner = ops, ops.kv_block_quantize
        self.calls, self.planes = 0, 0
        self.by_blocks: dict = {}
        self.worst = torch.zeros((), device="cuda")

    def __call__(self, blocks):
        vals, scales = self.inner(blocks)
        x = blocks.float().reshape(*scales.shape, -1)
        deq = vals.reshape(x.shape).float() * scales[..., None]
        err = (x.double() - deq.double()).abs().amax(-1)
        step = scales.double().clamp_min(1e-30)
        self.worst = torch.maximum(self.worst, (err / step).max().float())
        self.calls += 1
        self.planes += scales.numel()
        n = blocks.shape[0]
        self.by_blocks[n] = self.by_blocks.get(n, 0) + 1
        return vals, scales

    def __enter__(self):
        self.ops.kv_block_quantize = self
        return self

    def __exit__(self, *exc):
        self.ops.kv_block_quantize = self.inner


def tiered_phase(card: str):
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = ["--arch", "qwen1_5_0_5b", "--device", "cuda", "--seed", "0",
            "--tiered"]
    budget = serve.TIERED.host_tier_blocks * serve.block_bytes(
        get("qwen1_5_0_5b"), serve.TIERED, torch.float32)
    print(f"  traffic {serve.TIERED}", flush=True)

    print("  -- (a) exact fp32 cold tier", flush=True)
    ops.reset_launch_counts()
    exact_res = serve.main(args + ["--exact-cold"])
    counts_a = ops.launch_counts()
    report(exact_res, counts_a, "tiered (a)", card)
    st, cache = exact_res.engine.stats, exact_res.engine.cache.stats
    for ok, what in (
            (st.reload_blocks > 0, "no reload block"),
            (st.staged_hits + cache.staged_restores > 0,
             "no staged reload and no staged restore"),
            (exact_res.engine.pool.tier.demoted_blocks > 0,
             "no demoted block"),
            (st.spill_blocks > 0, "no spilled block"),
            (st.host_bytes <= budget,
             f"host bytes {st.host_bytes} over the budget {budget}")):
        if not ok:
            fail(f"tiered (a): {what}")
    check_launches(exact_res, counts_a, "tiered (a)")
    check_streams(exact_res, "tiered (a)")
    exact_res.engine.kill()

    print("  -- (b) int8 cold tier", flush=True)
    ops.reset_launch_counts()
    with QuantAudit(ops) as audit:
        int8_res = serve.main(args)
    counts_b = ops.launch_counts()
    report(int8_res, counts_b, "tiered (b)", card)
    st, tier = int8_res.engine.stats, int8_res.engine.pool.tier
    check_launches(int8_res, counts_b, "tiered (b)")
    if st.cold_blocks + tier.demoted_blocks <= 0:
        fail("tiered (b): nothing reached the int8 cold tier")
    if tier.cold_reload_blocks <= 0:
        fail("tiered (b): no cold block was reloaded")
    if counts_b["kv_block_quantize"] < 1 or counts_b["kv_block_dequantize"] < 1:
        fail("tiered (b): a kv_quant kernel never launched")
    worst = float(audit.worst)
    if not worst <= QUANT_BOUND_STEPS:
        fail(f"tiered (b): a dequantized value is {worst:.7f} steps off "
             f"(bound {QUANT_BOUND_STEPS:.7f})")
    print(f"  {audit.planes} planes in {audit.calls} quantize calls: worst "
          f"|x - dequant(quant(x))| = {worst:.7f} x scale (bound "
          f"{QUANT_BOUND_STEPS:.7f} = 1/2 + fp32 rounding); calls by "
          f"blocks per call {dict(sorted(audit.by_blocks.items()))}",
          flush=True)
    same = total = 0
    for (ra, _), (rb, _) in zip(exact_res.requests, int8_res.requests):
        a, b = exact_res.engine.outputs[ra.rid], int8_res.engine.outputs[rb.rid]
        same += sum(x == y for x, y in zip(a, b))
        total += len(a)
    print(f"  int8 cold tier: {same} of {total} output tokens "
          f"({100 * same / total:.1f} %) equal the exact pass's (not a "
          "gate: int8 is lossy)", flush=True)
    int8_res.engine.kill()
    return counts_a, counts_b


def fresh_peak() -> None:
    """Collect the earlier runs' engines (their pools and snapshots sit in
    reference cycles) before the peak is reset, so that the next
    ``max_memory_allocated`` counts only what is alive in the run."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def check_fleet_book(res, label: str) -> dict:
    """The two-leg path's accounting: the prefill replicas' exports, the
    decode replicas' adoptions and the router book's handoffs agree (every
    request with more than one output token crossed), every reservation
    settled, and nothing leaks on a live replica.  Reservations are capped
    at a decode replica's capacity (a zero-block miss beyond it), so
    reserved == adopted is held only when every reservation was a hit."""
    s, book = res.summary(), res.controller.book
    engines = res.replicas
    out = sum(e.stats.handoffs_out for e in engines if e.role == "prefill")
    adopted = sum(e.stats.handoffs_in for e in engines
                  if e.role == "decode")
    crossing = sum(r.output_len > 1 for r, _ in res.requests)
    if not out == adopted == book.handoffs == crossing:
        fail(f"{label}: exported {out}, adopted {adopted}, book "
             f"{book.handoffs}, requests crossing {crossing}")
    if not (s["handoff_blocks_out"] == s["handoff_blocks_in"]
            == book.handoff_blocks == book.adopted_blocks_total):
        fail(f"{label}: handoff blocks out {s['handoff_blocks_out']}, in "
             f"{s['handoff_blocks_in']}, book {book.handoff_blocks}, "
             f"adopted {book.adopted_blocks_total}")
    if not (s["handoff_bytes_out"] == s["handoff_bytes_in"]
            == book.handoff_bytes):
        fail(f"{label}: handoff bytes out {s['handoff_bytes_out']}, in "
             f"{s['handoff_bytes_in']}, book {book.handoff_bytes}")
    if book.reservation_hits + book.reservation_misses != book.handoffs:
        fail(f"{label}: {book.reservation_hits} hits + "
             f"{book.reservation_misses} misses != {book.handoffs} handoffs")
    if book.reserved_blocks_total > book.adopted_blocks_total or (
            book.reservation_misses == 0
            and book.reserved_blocks_total != book.adopted_blocks_total):
        fail(f"{label}: reserved {book.reserved_blocks_total} blocks, "
             f"adopted {book.adopted_blocks_total}, "
             f"{book.reservation_misses} misses")
    if book.reservations or any(st.reserved_blocks
                                for st in book.states.values()):
        fail(f"{label}: a reservation stands after the run")
    for iid, eng in res.controller.engines.items():
        leaks = [what for what, bad in (
            ("export state", eng._handoff_wait or eng._handoff_ready),
            ("used blocks", eng.bm.used_blocks),
            ("host-tier groups of requests", [
                rid for tier in (eng.pool.tier.hot, eng.pool.tier.cold)
                for rid in tier if rid >= 0])) if bad]
        if leaks:
            fail(f"{label}: replica {iid} ({eng.role}) leaks {leaks}")
    return s


def report_fleet(res, counts: dict, label: str, card: str,
                 before: int) -> None:
    """``before``: bytes allocated on the card when the run began (the
    shared weights), printed beside the run's peak."""
    report(res, counts, label, card)
    s = res.summary()
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{card}] {label}: replicas {s['instances']}, killed "
          f"{s['killed']}; handoffs {s['handoffs']} ({s['handoff_blocks']} "
          f"blocks, {s['handoff_bytes']} bytes, worker copy time "
          f"{s['handoff_copy_s']:.4f} s); reservations: hits "
          f"{s['reservation_hits']}, misses {s['reservation_misses']}, "
          f"reserved {s['reserved_blocks_total']} / adopted "
          f"{s['adopted_blocks_total']} blocks; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB, {before / 2**30:.3f} GiB of it "
          "allocated before the run", flush=True)


def kill_fleet(res) -> None:
    for eng in res.replicas:
        eng.kill()


def disagg_phase(card: str):
    """The disaggregated fleet at Qwen1.5-0.5B's full width on the serve
    traffic: (a) 1 prefill + 1 decode replica, fp32 wire; (b) the int8
    wire, 1 prefill + 2 decode replicas, twice; (c) prefill + decode +
    coloc, the decode replica killed after its first adoption."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = ["--arch", "qwen1_5_0_5b", "--device", "cuda", "--seed", "0",
            "--pd", "disagg", "--instances", "1", "--decode-instances", "1"]

    def run(label, extra=(), audit=None):
        fresh_peak()
        before = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        if audit is None:
            res = serve.main(args + list(extra))
        else:
            with audit:
                res = serve.main(args + list(extra))
        counts = ops.launch_counts()
        report_fleet(res, counts, label, card, before)
        check_launches(res, counts, label)
        check_fleet_book(res, label)
        return res, counts

    print("  -- (a) fp32 wire, 1 prefill + 1 decode replica", flush=True)
    res_a, counts_a = run("disagg (a)")
    s = res_a.summary()
    block = res_a.replicas[0].pool.tier.block_bytes
    if s["handoff_bytes_out"] != s["handoff_blocks_out"] * block:
        fail(f"disagg (a): {s['handoff_bytes_out']} wire bytes for "
             f"{s['handoff_blocks_out']} fp32 blocks of {block}")
    if counts_a["block_gather"] < s["handoffs_out"]:
        fail("disagg (a): fewer block_gather launches than exports")
    check_streams(res_a, "disagg (a)")
    cfg, params = res_a.cfg, res_a.params
    greedy = [res_a.outputs[r.rid] for r, _ in res_a.requests]
    kill_fleet(res_a)
    del res_a

    # (b) runs two decode replicas, so the decode leg never evicts: a
    # request the decode replica evicts and recomputes gets exact fp32 KV
    # where an adopted one keeps the int8 wire's, and which requests the
    # timing-driven scheduler evicts differs from run to run
    print("  -- (b) int8 wire, 1 prefill + 2 decode replicas, run twice",
          flush=True)
    audit = QuantAudit(ops)
    runs_b = []
    for i in (1, 2):
        label = f"disagg (b) run {i}"
        res, counts = run(label, ["--handoff-int8", "--decode-instances",
                                  "2"], audit if i == 1 else None)
        s = res.summary()
        recomputed = sum(e.stats.prefill_tokens for e in res.replicas
                         if e.role == "decode")
        if recomputed:
            fail(f"{label}: the decode replicas recomputed {recomputed} "
                 "tokens, so the streams depend on the schedule")
        if s["handoff_bytes_out"] >= s["handoff_blocks_out"] * block:
            fail(f"{label}: the int8 wire is not narrower")
        quant = sum(e.pool.quantize_calls for e in res.replicas
                    if e.role == "prefill")
        if not counts["kv_block_quantize"] == quant == s["handoffs_out"]:
            fail(f"{label}: kv_block_quantize launched "
                 f"{counts['kv_block_quantize']} times, the prefill "
                 f"replica quantized {quant}, exports {s['handoffs_out']}")
        if counts["kv_block_dequantize"] != s["handoffs_in"]:
            fail(f"{label}: kv_block_dequantize launched "
                 f"{counts['kv_block_dequantize']} times for "
                 f"{s['handoffs_in']} adoptions")
        streams = [res.outputs[r.rid] for r, _ in res.requests]
        runs_b.append((streams, s["handoff_bytes_out"], counts))
        kill_fleet(res)
        del res
    if runs_b[0][:2] != runs_b[1][:2]:
        fail("disagg (b): two int8 runs differ in streams or wire bytes")
    worst = float(audit.worst)
    if audit.calls < 1 or not worst <= QUANT_BOUND_STEPS:
        fail(f"disagg (b): {audit.calls} quantize calls, worst "
             f"{worst:.7f} steps (bound {QUANT_BOUND_STEPS:.7f})")
    same = sum(a == b for a, b in zip(runs_b[0][0], greedy))
    tokens = sum(sum(x == y for x, y in zip(a, b))
                 for a, b in zip(runs_b[0][0], greedy))
    print(f"  int8 wire: both runs identical ({runs_b[0][1]} wire bytes); "
          f"{audit.planes} planes in {audit.calls} quantize calls, worst "
          f"|x - dequant(quant(x))| = {worst:.7f} x scale (bound "
          f"{QUANT_BOUND_STEPS:.7f}); {same} of {len(greedy)} streams and "
          f"{tokens} of {sum(map(len, greedy))} tokens equal greedy "
          "forward (not a gate: int8 is lossy)", flush=True)

    print("  -- (c) churn: prefill + decode + coloc, the decode replica "
          "killed after its first adoption", flush=True)
    killed = []

    def after_round(ctl):
        for iid, eng in list(ctl.engines.items()):
            if eng.role == "decode" and eng.stats.handoffs_in and not killed:
                killed.append(iid)
                ctl.kill_instance(iid)

    fresh_peak()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res_c = serve.serve_fleet(cfg, params, serve.FULL,
                              roles=("prefill", "decode", "coloc"),
                              pd_mode="disagg", device="cuda",
                              after_round=after_round)
    counts_c = ops.launch_counts()
    report_fleet(res_c, counts_c, "disagg (c)", card, before)
    if not killed:
        fail("disagg (c): the decode replica never adopted a payload")
    check_launches(res_c, counts_c, "disagg (c)")
    check_streams(res_c, "disagg (c)")
    for r, _ in res_c.requests:
        if len(res_c.emitted[r.rid]) != r.output_len:
            fail(f"disagg (c): rid {r.rid} emitted "
                 f"{len(res_c.emitted[r.rid])} tokens for {r.output_len}")
    kill_fleet(res_c)
    return counts_a, runs_b[0][2], runs_b[1][2], counts_c


COPY_KERNELS = ("quantize_kernel", "dequantize_kernel", "gather_kernel")
SCHED_KEYS = ("iterations", "decode_launches", "packed_prefill_calls",
              "prefill_tokens", "evictions", "offload_blocks", "tdg_ratio")


def thread_cpu_s(native_id: int) -> float:
    """User + system CPU seconds of one thread of this process (Linux)."""
    import os
    fields = Path(f"/proc/self/task/{native_id}/stat").read_text() \
        .rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class MethodTimer:
    """Wall seconds and calls of chosen methods, summed while the context
    is active (each method is wrapped on its class and restored on exit;
    a wrapper costs about a microsecond a call)."""

    def __init__(self, targets):
        self.targets = targets            # [(class, method name)]
        self.seconds = {f"{c.__name__}.{n}": 0.0 for c, n in targets}
        self.calls = dict.fromkeys(self.seconds, 0)
        self._saved = []

    def __enter__(self):
        for cls, name in self.targets:
            orig = cls.__dict__[name]
            static = isinstance(orig, staticmethod)
            fn = orig.__func__ if static else orig
            key = f"{cls.__name__}.{name}"

            def timed(*a, _fn=fn, _key=key, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_key] += time.perf_counter() - t0
                    self.calls[_key] += 1

            setattr(cls, name, staticmethod(timed) if static else timed)
            self._saved.append((cls, name, orig))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def host_profile(cfg, params, out_dir: Path) -> None:
    """Where the lanes' extra wall goes on the host: the serve traffic in
    six turns (off, on, on, off, off, on), unprofiled but for
    ``MethodTimer`` on the engine thread's step parts and the transfer
    worker's copy parts, with each thread's CPU time and the plan
    (iterations, launches, prefill tokens), so that a change of plan is
    told apart from host overhead.  Prints the per-part medians of each
    side and writes every run to ``out_dir/host_serve.json``."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.transfer import TransferWorker

    targets = [(Engine, n) for n in (
        "step", "_run_prefill_packed", "_run_decode", "_sync_pool_with_bm",
        "_dispatch_offloads", "_drain_transfers", "_prefetch_reloads",
        "_sync_tier_state")] + [(TransferWorker, n) for n in (
            "_execute", "_to_pinned", "_sync", "_unpin", "_to_device")]
    runs = {"off": [], "on": []}
    for overlap in (False, True, True, False, False, True):
        cpu0 = time.thread_time()
        with MethodTimer(targets) as timer:
            res = serve.serve(cfg, params, serve.FULL, seed=0,
                              overlap_transfers=overlap)
        worker = res.engine.worker
        summary = res.summary()
        runs["on" if overlap else "off"].append({
            "wall_s": res.wall_s,
            "engine_cpu_s": time.thread_time() - cpu0,
            "worker_cpu_s": (thread_cpu_s(worker._thread.native_id)
                             if worker is not None and worker._thread
                             else 0.0),
            "plan": {k: summary[k] for k in SCHED_KEYS},
            "seconds": timer.seconds, "calls": timer.calls})
        res.engine.kill()
    med = lambda side, f: float(np.median([f(r) for r in runs[side]]))
    print("  host parts, serve traffic, median of 3 runs each side "
          "(lanes off | on):", flush=True)
    for label, f in (("wall", lambda r: r["wall_s"]),
                     ("engine thread CPU", lambda r: r["engine_cpu_s"]),
                     ("worker thread CPU", lambda r: r["worker_cpu_s"]),
                     ("outside Engine.step", lambda r: r["wall_s"]
                      - r["seconds"]["Engine.step"])):
        print(f"  {med('off', f):9.4f} | {med('on', f):9.4f} s  {label}",
              flush=True)
    for key in runs["on"][0]["seconds"]:
        print(f"  {med('off', lambda r: r['seconds'][key]):9.4f} | "
              f"{med('on', lambda r: r['seconds'][key]):9.4f} s  {key} (calls "
              f"{runs['off'][0]['calls'][key]} | {runs['on'][0]['calls'][key]})",
              flush=True)
    for side, rs in runs.items():
        print(f"  plans, lanes {side}: " + "; ".join(
            str(r["plan"]) for r in rs), flush=True)
    (out_dir / "host_serve.json").write_text(json.dumps(runs, indent=1))


def profile_phase(out_dir: Path) -> None:
    """Runs only with ``--profile``.  (1) The serve traffic with the
    transfer lanes off and on, in turns (off, on, on, off): the walls;
    then six more turns with the host parts timed (``host_profile``).
    (2) The serve traffic, the tiered traffic (exact cold tier), the serve
    traffic speculating with a same-weights draft and on the per-request
    paths, each served twice more, the second time under torch.profiler:
    device time
    by kernel, the share of the three copy kernels, the device's busy
    share of the first (unprofiled) run's wall, and the copy engines'
    time (memcpy rows, which overlap the kernels on the copy stream);
    written to ``out_dir/kernels_<traffic>.json``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    cfg = get("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))

    def run(traffic, **kw):
        res = serve.serve(cfg, params, traffic, seed=0, **kw)
        res.engine.kill()
        return res

    walls = {True: [], False: []}
    for overlap in (False, True, True, False):
        walls[overlap].append(run(serve.FULL,
                                  overlap_transfers=overlap).wall_s)
    print(f"  serve wall, lanes off: {walls[False]} s; lanes on: "
          f"{walls[True]} s (turns off, on, on, off)", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    host_profile(cfg, params, out_dir)
    for label, traffic, kw in (("serve", serve.FULL, {}),
                               ("tiered", serve.TIERED,
                                {"cold_quantize": False}),
                               ("spec", serve.FULL,
                                {"spec_k": 2, "draft": (cfg, params)}),
                               ("per-request", serve.FULL,
                                {"packed_prefill": False,
                                 "fused_decode": False})):
        plain_wall = run(traffic, **kw).wall_s
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            res = run(traffic, **kw)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows = []      # device rows only: host ops would count twice
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, evt.key, evt.count))
        rows.sort(reverse=True)
        memcpy = sum(r[0] for r in rows if r[1].startswith("Memcpy")) / 1e6
        busy = sum(r[0] for r in rows
                   if not r[1].startswith(("Memcpy", "Memset"))) / 1e6
        copy = sum(r[0] for r in rows
                   if any(k in r[1] for k in COPY_KERNELS)) / 1e6
        st = res.engine.stats
        print(f"  [{label}] kernels busy {busy:.3f} s = "
              f"{100 * busy / plain_wall:.1f} % of the unprofiled wall "
              f"{plain_wall:.3f} s (idle "
              f"{100 * (1 - busy / plain_wall):.1f} %); profiled wall "
              f"{wall:.3f} s; copy kernels {1e3 * copy:.3f} ms = "
              f"{100 * copy / busy:.2f} % of kernel time; memcpy (copy "
              f"engines) {memcpy:.3f} s; iterations {st.iterations}, "
              f"decode launches {st.decode_launches}, packed prefill calls "
              f"{st.packed_prefill_calls}, prefill_chunk calls "
              f"{st.prefill_chunk_calls}, draft launches "
              f"{st.draft_launches}", flush=True)
        for dev_us, key, count in rows[:25]:
            print(f"  {dev_us / 1e3:10.3f} ms {100 * dev_us / 1e6 / busy:5.1f}"
                  f" % x{count:6d}  {key[:90]}", flush=True)
        (out_dir / f"kernels_{label}.json").write_text(json.dumps(
            {"wall_s": plain_wall, "profiled_wall_s": wall,
             "device_busy_s": busy, "copy_kernels_s": copy,
             "memcpy_s": memcpy, "lanes_off_walls_s": walls[False],
             "lanes_on_walls_s": walls[True],
             "rows": [{"device_ms": d / 1e3, "name": k, "count": c}
                      for d, k, c in rows]}, indent=1))


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    dev = torch.device("cuda")

    phase("env")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{smi.split(',')[0].strip()} @ {smi.split(',')[1].strip()}"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)

    phase("build")
    from repro_torch.kernels import build
    t0 = time.monotonic()
    log = build.build(verbose=True)
    for line in log.splitlines():
        if line.startswith("==") or "Compiling entry" in line \
                or "spill" in line or "Used" in line:
            print("  " + line.strip(), flush=True)
    # the attention bodies keep their fragments and accumulators in
    # registers: no instance may spill
    for src in ("packed_prefill.cu", "paged_attention.cu"):
        src_log = log.split(f"== {src}", 1)[1].split("\n==")[0]
        spills = [m.group(0) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", src_log)
            if int(m.group(1)) or int(m.group(2))]
        if spills:
            fail(f"{src} spills: {spills}")
        print(f"  {src}: {src_log.count('Compiling entry')} instances, "
              f"no spill", flush=True)
    print(f"  built {build.BUILD_DIR / build.LIB_NAME} in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    build.library()

    phase("kernels")
    kres = kernels_phase(dev)

    phase("serve")
    counts, counts_off, plain_decode = serve_phase(card)

    phase("tiered")
    counts_a, counts_b = tiered_phase(card)

    phase("spec")
    counts_same, counts_other = spec_phase(card, plain_decode)

    phase("per-request")
    counts_pr = per_request_phase(card)

    phase("glm")
    counts_glm = glm_phase(card)

    phase("disagg")
    counts_da, counts_db1, counts_db2, counts_dc = disagg_phase(card)

    if "--profile" in sys.argv[1:]:
        phase("profile")
        profile_phase(ROOT / "build" / "profile")

    main_path = {**kres["qwen1.5-0.5b"], **kres["copy"]}
    meta = {
        "paged_decode_attention": dict(
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:88"),
        "packed_prefill_attention": dict(
            source="src/repro_torch/csrc/packed_prefill.cu",
            replaces="src/repro/kernels/chunked_prefill.py:148"),
        "chunked_prefill_attention": dict(
            source="src/repro_torch/csrc/packed_prefill.cu",
            replaces="src/repro/kernels/chunked_prefill.py:204"),
        "packed_verify_attention": dict(
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/spec_verify.py:90"),
        "kv_block_quantize": dict(
            source="src/repro_torch/csrc/kv_quant.cu",
            replaces="src/repro/kernels/kv_quant.py:55"),
        "kv_block_dequantize": dict(
            source="src/repro_torch/csrc/kv_quant.cu",
            replaces="src/repro/kernels/kv_quant.py:78"),
        "block_gather": dict(
            source="src/repro_torch/csrc/block_gather.cu",
            replaces="src/repro/kernels/block_gather.py:23"),
    }
    # launches: the main paths' runs (serve with the lanes on and off,
    # tiered (a), tiered (b), spec with both drafts, per-request, glm, the
    # disagg passes), each read right after its run with the counts set to
    # 0 just before it
    runs = {"serve": counts, "serve, lanes off": counts_off,
            "tiered (a)": counts_a, "tiered (b)": counts_b,
            "spec, same draft": counts_same,
            "spec, other draft": counts_other, "per-request": counts_pr,
            "glm": counts_glm, "disagg (a)": counts_da,
            "disagg (b) run 1": counts_db1, "disagg (b) run 2": counts_db2,
            "disagg (c)": counts_dc}
    launches = {name: sum(c[name] for c in runs.values()) for name in meta}
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} never launched on the main paths")
    print("  launches: " + "; ".join(f"{k} {v}" for k, v in runs.items()),
          flush=True)
    line = {"kernels": [
        {"name": name, "route": "cuda", **meta[name],
         "launches": launches[name],
         "max_abs_err": main_path[name]["max_abs_err"],
         "ms": main_path[name]["ms"], "kernel_ms": main_path[name]["ms"],
         "plain_ms": main_path[name]["plain_ms"],
         "bound_ms": main_path[name]["bound_ms"],
         "bound_by": main_path[name]["bound_by"],
         "library_ms": main_path[name]["library_ms"]}
        for name in meta]}
    print(f"\n{card}; total {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
