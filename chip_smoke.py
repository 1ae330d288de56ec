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
               Qwen2-7B's GQA widths (H 28, Hkv 4, hd 128) and the moe
               phase's OLMoE-1B-7B widths (H = Hkv = 16, hd 128, with
               block gather on its (16, 2, 160, 16, 16, 128) pool):
               attention at fp32 atol = rtol = 2e-5, the copy kernels (int8 quantize /
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
  9. moe     — ``launch/serve.py``'s ``serve`` at OLMoE-1B-7B's full
               published width and depth (16 layers, d_model 2048, 16 / 16
               heads, hd 128, 64 experts, top-8, d_expert 1024, vocab 50304,
               QK-norm; 6.92 B fp32 parameters, 27.7 GB, from seed 0) on
               the serve traffic with the transfer lanes on.  (a) At the
               dropless capacity factor n_experts / top_k = 8 (a
               ``dataclasses.replace`` of the config): evictions, every
               stream equals greedy forward (``last_only`` forwards), the
               serve phase's launch-count and host-sync gates.  (b) At the
               published capacity factor 1.25, after one warm-up pass:
               two runs with identical streams, every request done, the
               same gates, and the routed slots each packed prefill call
               dropped, counted by a wrapper around ``moe.moe_forward``
               (a run with none fails).  The weights are freed after it.
 10. families — ``prefill`` + ``decode_step`` against teacher-forced
               ``forward`` (batch 2, 8 decode steps, fp32): Mamba2-1.3B
               (48 layers), Hymba-1.5B (32 layers, a 1100-token prompt
               past its 1024 window), Whisper-small (12 + 12 layers, 1500
               stub frames), all at full width and depth, and
               Qwen1.5-MoE-A2.7B at full width cut to 4 layers at its
               dropless capacity factor (57 GB at full depth): every
               step's logits within 1e-3 of forward's, the same argmax.
 11. disagg  — ``serve --pd disagg`` at Qwen1.5-0.5B's full width on the
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
 12. sim     — the live coloc engine at Qwen1.5-0.5B's full width over a
               profiling schedule of decode-heavy, mixed and prefill-only
               steps (each step's work items and measured latency, as
               ``Engine._profile`` records them): the §4.1 estimator
               (``BatchLatencyEstimator.fit``) fitted on three of four
               steps, its held-out MAPE printed beside the H100
               ``AnalyticalExecutor``'s (Qwen1.5-0.5B fp32 profile at
               the card's fp32 peak, ``t_launch`` from the smallest
               measured step of the fitting split) and their
               predicted / measured ratios by step kind; no online refit
               failed; the serve phase's launch-count and host-sync gates.
               Then ``replay_sim`` of the frontend phase's trace on that
               executor, twice: identical rows (all but ``wall_s``), every
               request complete.
 13. frontend — ``ServiceFrontend`` over torch replicas on their
               ``EngineDriver`` threads (``launch/serve.py``
               ``serve_frontend``, the path of ``--mode frontend``): the
               first 64 requests of the industrial trace (3 priority
               classes, seed 1) replayed at 1000x, prompts clipped to 512
               and outputs to 16 tokens, the SLOs of ``serve.PRIORITIES``,
               160-block replicas, the router and the book on the sim
               phase's fitted estimator.  (a) 2 coloc replicas; (b) 1
               prefill + 2 decode replicas, fp32 wire; (c) 2 coloc
               replicas, replica 0 killed after its first token.  Every
               pass: every stream equals greedy forward, each token
               emitted once, drain() True, no driver thread died, the
               serve phase's launch-count and host-sync gates; (b)
               exports = adoptions = book handoffs = the requests with
               more than one output token; (c) every orphan re-dispatched
               and complete.  Client-edge TTFT / TPOT p50 / p99 per
               priority, SLO attainment, TDG_Ratio, per-replica
               iterations, wall, peak memory and the sim's row for the
               same trace printed.
 14. train   — the training path (``repro_torch.training`` through
               ``models.model.forward_train``; plain autograd, no CUDA
               kernel of the port, none launched) at Qwen1.5-0.5B's full
               published width and depth, fp32, weights from seed 0.
               (a) One step's loss and every gradient leaf on the card
               against the same step on this machine's CPU from the same
               weights (2 x 256 tokens, cut from 8 x 512 by the CPU's
               time): loss rel 1e-5, each leaf within 1e-4 of its max
               |g|; before that gate, the CPU, its threads and BLAS, and
               each side's gradients against a float64 CPU run and
               against a second run of its own are printed.  (b)
               ``launch/train.py``'s ``train``: 12 steps of 8 x 512
               cycling 3 batches at lr 1e-3, the last loss below 0.9x
               the first; step time (median after the first), tokens/s,
               FLOP share of the fp32 peak and peak memory printed.  (c)
               microbatches 2 = 1 on one 8 x 512 batch: loss and grad
               norm rel 1e-5, params 1e-4 but where the gradient is at
               fp32 noise (<= 1e-5 of its leaf's max |g|: AdamW's first
               step moves those ~lr either way), 2 lr; the count of such
               entries printed.  (d) remat gradients within 1e-6 of each
               leaf's max |g| of the plain ones; bitwise equality and
               each run's peak memory printed.  (e) int8 error-feedback
               gradients, 10 steps cycling 2 batches: the loss falls.
               (f) 2 steps, ``save_async``, 2 more while it writes, then
               restore into fresh tensors and redo those 2: params and
               moments within 1e-6 of the uninterrupted run.  (g)
               OLMoE-1B-7B (4 of 16 layers), Mamba2-1.3B and Hymba-1.5B
               (8 x 512 in SSD chunks of 16: at the configs' 256 the
               reference's ``_segsum_decay`` gives NaN gradients, whose
               count is printed) and Whisper-small (8 x 448 over 1500
               frames), full width, remat on, lr 1e-5, 3 steps on one
               batch: loss and gradient norm finite, the loss falls.
 15. mesh    — ``launch/steps.py``'s sharded steps on a one-rank NCCL
               world and a (1, 1) ``("data", "model")`` ``DeviceMesh``
               (DTensor parameters, caches and batches placed by the
               sharding rules; on one rank every placement is
               ``Replicate()``), Qwen1.5-0.5B at full published width and
               depth, fp32, weights from seed 0, each against the
               unsharded port function on the card: ``build_prefill_step``
               at 4 x 2048 (logits and cache within 2e-5);
               ``build_serve_step`` with 8 rows of 1024-token prompts in a
               2048-position cache, 16 greedy tokens (tokens equal,
               logits and cache within 2e-5); ``build_train_step`` at 8 x
               512 (loss rel 1e-5, each gradient leaf within 1e-4 of its
               max |g|).  Whether each is bitwise, times and peak memory
               printed; no kernel of the port launched; the process group
               destroyed at the end.
 16. dryrun  — ``launch/dryrun.py``'s cost model held to the card: on a
               one-rank NCCL world and a (1, 1) mesh, Qwen1.5-0.5B at full
               width in bf16 (weights from seed 0), at the mesh phase's
               shapes, each step traced on meta tensors and priced, then
               run: the card's ``FlopCounterMode`` flops equal the
               prediction, the placed inputs' bytes equal the predicted
               argument bytes, the median of 5 timed steps is at least
               max(compute, memory) of the H100 roofline, and the peak
               above the inputs is at least 0.95 x the predicted peak.

fp32 matmuls run in full fp32: TF32 is switched off for cuBLAS and cuDNN.
The last two lines are the ``{"kernels": ...}`` JSON and the
``{"ok": true, ...}`` JSON.
"""
from __future__ import annotations

import gc
import json
import os
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
        # the moe phase's attention: 16 / 16 heads of 128 (G 1, hd 128)
        # on the same buckets, and its pool (16 layers x K/V, 160 blocks)
        # in the offload snapshot's form
        "olmoe-1b-7b": dict(
            decode=(16, 16, 16, 128, 16, 48,
                    [1, 3, 16, 17, 50, 128, 200, 255, 256, 390, 512, 513,
                     640, 701, 767, 768]),
            prefill=(8, 512, 512, 16, 16, 128,
                     [0, 0, 64, 0, 128, 0, 0, 0]),
            gather=(16, 160, 16, 16, 128, 8)),
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
        if "gather" in c:
            g = gather_case(rng, *c["gather"], dev)
            g["bound_ms"], g["bound_by"] = g.pop("bound")
            results[label]["block_gather"] = g
        for name, r in results[label].items():
            print(f"  {name}: kernel {r['ms']:.4f} ms (warm L2 "
                  f"{r['warm_l2_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                  f"[{r['shape']}]", flush=True)
    results["slice 6"] = slice6_kernels(rng, dev)
    return results


def gather_case(rng, layers, nblk, bs, hkv, hd, n, dev) -> dict:
    """block_gather of n blocks from a pool (layers, 2, nblk, bs, hkv,
    hd) in the offload snapshot's form (block_dim 2): bitwise against its
    plain version, then timed beside ``index_select``; the bound as
    ``bound=(ms, by)``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import block_gather

    kv = torch.as_tensor(rng.standard_normal((layers, 2, nblk, bs, hkv, hd)),
                         dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.permutation(nblk)[:n], dtype=torch.int32)
    idx_dev = idx.to(dev)
    err = exact(f"block_gather (planes {layers * 2})",
                block_gather(kv, idx, 2),
                ref.block_gather_ref(kv, idx_dev, 2).contiguous())
    g_k, g_p = turns(lambda: block_gather(kv, idx, 2),
                     lambda: ref.block_gather_ref(kv, idx_dev, 2)
                     .contiguous())
    # library: index_select along the block axis moves the same bytes
    return dict(
        max_abs_err=err, ms=float(np.mean(g_k)), plain_ms=float(np.mean(g_p)),
        library_ms=time_ms(lambda: torch.index_select(kv, 2, idx_dev)),
        warm_l2_ms=time_ms(lambda: block_gather(kv, idx, 2), cold_l2=False),
        bound=bound(2 * n * layers * 2 * bs * hkv * hd * 4, 0),
        shape=f"pool {tuple(kv.shape)} block_dim 2, n {n}")


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
        # the offload snapshot's form: the serve pool, 48 planes
        "block_gather": gather_case(rng, lyr, nblk, bs, hkv, hd, n, dev),
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


# --------------------------------------------------------------------------
# moe and families phases: the other model families on the card
# --------------------------------------------------------------------------

class DropAudit:
    """Wraps ``moe.moe_forward`` for one run and counts, with the port's
    own router (``moe.route``), the routed slots dropped by each call on a
    flat (1, T, d) stream: a packed prefill call makes ``n_layers`` such
    calls, decode and verify rows are (R, 1, d).  The counts stay on the
    card until the run is over."""

    def __init__(self, moe, n_layers: int):
        self.moe, self.inner, self.n_layers = moe, moe.moe_forward, n_layers
        self.layers: list = []         # (T, dropped slots) per layer call

    def __call__(self, x, p, top_k, capacity_factor=1.25):
        if x.shape[0] == 1 and x.shape[1] > 1:
            keep = self.moe.route(x, p, top_k, capacity_factor).keep
            self.layers.append((x.shape[1], (~keep).sum()))
        return self.inner(x, p, top_k, capacity_factor)

    def per_call(self) -> list:
        """(T, slots dropped over the call's layers) per packed prefill."""
        n = self.n_layers
        return [(self.layers[i][0],
                 int(sum(int(d) for _, d in self.layers[i:i + n])))
                for i in range(0, len(self.layers), n)]

    def __enter__(self):
        self.moe.moe_forward = self
        return self

    def __exit__(self, *exc):
        self.moe.moe_forward = self.inner


def moe_phase(card: str, dev="cuda"):
    """``launch/serve.py``'s ``serve`` at OLMoE-1B-7B's full published
    width and depth (16 layers, d_model 2048, 16 / 16 heads, hd 128, 64
    experts, top-8, d_expert 1024, vocab 50304, QK-norm; fp32 weights from
    ``init_params`` at seed 0) on the serve traffic with the transfer
    lanes on.  (a) At the dropless capacity factor n_experts / top_k:
    every stream equals greedy forward under the serve phase's
    launch-count and host-sync gates, with evictions.  (b) At the
    published 1.25, twice: identical streams, every request done, the
    same gates, and slots dropped in the packed prefill calls."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import init_params

    fresh_peak()
    t0 = time.monotonic()
    pub = get("olmoe_1b_7b")
    exact = dataclasses.replace(pub,
                                capacity_factor=pub.n_experts / pub.top_k)
    params = init_params(pub, torch.Generator(dev).manual_seed(0),
                         device=dev)
    n_params = sum(t.numel() for t in iter_leaves(params))
    print(f"  {pub.name}: {n_params} parameters, "
          f"{n_params * 4 / 1e9:.2f} GB fp32; KV block "
          f"{serve.block_bytes(pub, serve.FULL, torch.float32) / 2**20:.1f} "
          f"MiB; init {time.monotonic() - t0:.1f} s", flush=True)

    print(f"  -- (a) exact pass, capacity factor {exact.capacity_factor}",
          flush=True)
    ops.reset_launch_counts()
    t1 = time.monotonic()
    res = serve.serve(exact, params, serve.FULL, seed=0, device=dev)
    counts_a = ops.launch_counts()
    t_serve = time.monotonic() - t1
    st = res.engine.stats
    report(res, counts_a, "moe (a)", card)
    if st.evictions < 1:
        fail("moe (a): no eviction")
    check_launches(res, counts_a, "moe (a)")
    check_streams(res, "moe (a)")
    streams_a = [res.outputs[r.rid] for r, _ in res.requests]
    print(f"  [{card}] moe (a): serve {t_serve:.1f} s (wall "
          f"{res.wall_s:.3f} s); {st.decode_launches} decode launches, "
          f"{st.packed_prefill_calls} packed prefill calls "
          f"(paged_decode_attention x{counts_a['paged_decode_attention']}, "
          f"packed_prefill_attention x{counts_a['packed_prefill_attention']})",
          flush=True)
    res.engine.kill()
    del res

    # the engine's clock is the measured step time and SlideBatching reads
    # it (deadlines, urgency), so a pass whose first calls are cold can
    # pack its prefills differently, and capacity drops follow the
    # packing: one warm-up pass first, then the two gated runs
    print(f"  -- (b) published capacity factor {pub.capacity_factor}: a "
          "warm-up pass, then two runs", flush=True)
    counts_b, streams_b, packs = [], [], []
    for run in (0, 1, 2):
        ops.reset_launch_counts()
        with DropAudit(moe, pub.n_layers) as audit:
            res = serve.serve(pub, params, serve.FULL, seed=0, device=dev)
        label = f"moe (b) run {run}" if run else "moe (b) warm-up"
        streams = [res.outputs[r.rid] for r, _ in res.requests]
        calls = audit.per_call()
        if not run:
            print(f"  {label}: wall {res.wall_s:.3f} s, "
                  f"{res.engine.stats.iterations} iterations, dropped "
                  f"slots per packed prefill call {calls}", flush=True)
            warm_streams = streams
            res.engine.kill()
            del res
            continue
        counts_b.append(ops.launch_counts())
        report(res, counts_b[-1], label, card)
        check_launches(res, counts_b[-1], label)
        streams_b.append(streams)
        packs.append([t for t, _ in calls])
        if len(calls) != res.engine.stats.packed_prefill_calls:
            fail(f"{label}: {len(calls)} audited calls, "
                 f"{res.engine.stats.packed_prefill_calls} packed prefills")
        total = sum(d for _, d in calls)
        print(f"  {label}: dropped routed slots per packed prefill call "
              f"(flat tokens: slots over {pub.n_layers} layers) {calls}; "
              f"total {total}", flush=True)
        if total < 1:
            fail(f"{label}: no routed slot dropped: the capacity path was "
                 "not exercised")
        res.engine.kill()
        del res
    if streams_b[0] != streams_b[1]:
        fail("moe (b): the two runs' streams differ (packed prefill "
             f"lengths {'equal' if packs[0] == packs[1] else 'differ'}: "
             f"{packs[0]} vs {packs[1]})")
    same = sum(a == b for a, b in zip(streams_a, streams_b[0]))
    print(f"  moe (b): streams identical in both runs; {same} of "
          f"{len(streams_a)} equal the dropless pass's, the warm-up's "
          f"{'too' if warm_streams == streams_b[0] else 'differ'} (not "
          "gates)", flush=True)
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [{card}] moe: phase {time.monotonic() - t0:.1f} s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left after "
          "freeing the weights", flush=True)
    return counts_a, counts_b[0], counts_b[1]


def iter_leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from iter_leaves(v)
        else:
            yield v


# prefill + decode_step against teacher-forced forward on the card, fp32
FAMILY_ATOL = 1e-3
# (arch, prompt length, decode steps, layers kept: None = all)
FAMILY_CASES = (("mamba2_1_3b", 64, 8, None),
                ("hymba_1_5b", 1100, 8, None),     # past the 1024 window
                ("whisper_small", 64, 8, None),    # 1500 stub frames
                ("qwen2_moe_a2_7b", 64, 8, 4))     # 57 GB at full depth


def families_phase(card: str, dev="cuda") -> None:
    """``prefill`` + ``decode_step`` against teacher-forced ``forward`` for
    an SSM, a hybrid with its ring cache, an encoder-decoder and an MoE
    config at full width (qwen2-moe cut to 4 layers), batch 2, fp32
    weights from ``init_params`` at seed 0: every step's logits within
    FAMILY_ATOL of forward's, with the same argmax."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)

    for arch, s, extra, n_layers in FAMILY_CASES:
        fresh_peak()
        t0 = time.monotonic()
        cfg = get(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        if cfg.family == "moe":            # dropless: forward = prefill
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        n_params = sum(t.numel() for t in iter_leaves(params))
        gen = torch.Generator(dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, s + extra), generator=gen,
                             device=dev)
        kw = {}
        if cfg.family == "encdec":
            kw["enc_inputs"] = torch.randn(
                (2, cfg.enc_frames, cfg.d_model), generator=gen,
                device=dev) * 0.02
        full = forward(cfg, params, toks, **kw)
        t1 = time.monotonic()
        lg, cache = prefill(cfg, params, toks[:, :s], max_seq=s + extra,
                            **kw)
        steps = [lg]
        for i in range(extra):
            lg, cache = decode_step(cfg, params, cache, toks[:, s + i])
            steps.append(lg)
        torch.cuda.synchronize()
        t_serve = time.monotonic() - t1
        worst, margin = 0.0, float("inf")
        for i, got in enumerate(steps):
            want = full[:, s - 1 + i]
            worst = max(worst, float((got - want).abs().max()))
            top2 = torch.topk(want, 2).values
            margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
            if not torch.equal(got.argmax(-1), want.argmax(-1)):
                fail(f"families {arch}: argmax differs from forward at "
                     f"step {i}")
            if not torch.isfinite(got).all():
                fail(f"families {arch}: non-finite logits at step {i}")
        if not worst <= FAMILY_ATOL:
            fail(f"families {arch}: max abs error {worst:.3e} > "
                 f"{FAMILY_ATOL}")
        cache_keys = {k: tuple(v.shape) for k, v in cache.items()}
        print(f"  [{card}] {cfg.name} ({cfg.family}, {cfg.n_layers} "
              f"layers, {n_params} parameters): prompt {s} + {extra} "
              f"decode steps, batch 2: max abs error {worst:.3e} "
              f"(tolerance {FAMILY_ATOL}), argmax equal at all "
              f"{extra + 1} steps (smallest top-2 margin {margin:.3e}); "
              f"prefill + decode {t_serve:.2f} s, phase "
              f"{time.monotonic() - t0:.1f} s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"cache {cache_keys}", flush=True)
        del params, cache, full, steps
        gc.collect()
        torch.cuda.empty_cache()


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


# ---------------------------------------------------------------------------
# sim and frontend phases: the simulator against the card, the async tier
# ---------------------------------------------------------------------------

def step_kind(items) -> str:
    pre = sum(1 for _, _, p in items if p)
    return ("prefill" if pre == len(items) else "decode" if pre == 0
            else "mixed")


def sim_phase(card: str, dev="cuda"):
    """The live coloc engine at Qwen1.5-0.5B's full width over a profiling
    schedule of decode-heavy, mixed and prefill-heavy steps: every step's
    (work items, measured latency) is what ``Engine._profile`` records.
    Three of four steps fit ``BatchLatencyEstimator``; the fourth are held
    out for its MAPE and the H100 ``AnalyticalExecutor``'s (Qwen1.5-0.5B
    fp32 profile priced at the card's fp32 peak, ``t_launch`` from the
    training split's smallest step).  Then
    ``replay_sim`` of the frontend phase's trace on that executor, twice:
    identical rows, every request complete."""
    from repro_torch.configs import get
    from repro_torch.core import (SLO, BatchLatencyEstimator, EngineConfig,
                                  GoRouting, Request, RouterConfig,
                                  make_policy)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine
    from repro_torch.sim import (AnalyticalExecutor, ClusterConfig,
                                 ClusterSim, InstanceHardware,
                                 QWEN1_5_0_5B_FP32, replay_sim)
    from types import SimpleNamespace

    cfg = get("qwen1_5_0_5b")
    fresh_peak()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=serve.W_P, tau=1e9),
                 make_policy("slidebatching"), num_blocks=1024,
                 block_size=16, device=dev)
    rng = np.random.default_rng(5)
    added = []

    def add(n, lo, hi, out):
        for _ in range(n):
            plen = int(rng.integers(lo, hi + 1))
            r = Request(prompt_len=plen, output_len=out, arrival=eng.now,
                        slo=SLO(60.0, 60.0),
                        priority=int(rng.integers(1, 4)))
            prompt = rng.integers(1, cfg.vocab, plen).astype(np.int32)
            eng.add_request(r, prompt)
            added.append((r, prompt))

    # decode-heavy base (16 short prompts, 96 tokens each), mixed steps
    # from a pair of long prompts every 6 steps while it decodes, then
    # prefill-only waves of one-token requests; the decode batch shrinks
    # as the base finishes
    schedule = {0: (16, 16, 64, 96)}
    schedule.update({6 * k: (2, 128, 768, 8) for k in range(1, 16)})
    schedule.update({110 + 4 * k: (1 + k % 4, 256, 768, 1)
                     for k in range(10)})
    ops.reset_launch_counts()
    profile = []
    t0 = time.monotonic()
    for i in range(2000):
        if i in schedule:
            add(*schedule[i])
        res = eng.step()
        if res is not None:
            profile.append((res["plan"].work_items(), res["latency"]))
        elif not eng.has_work() and i > max(schedule):
            break
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    run = SimpleNamespace(cfg=cfg, replicas=[eng], requests=added)
    check_launches(run, counts, "sim profile")
    if any(r.generated < r.output_len for r, _ in added):
        fail("sim: a profiling request did not finish")
    if eng.stats.refit_failures:
        fail(f"sim: {eng.stats.refit_failures} online refits failed")
    kinds = {k: sum(step_kind(b) == k for b, _ in profile)
             for k in ("decode", "mixed", "prefill")}
    if min(kinds.values()) < 5:
        fail(f"sim: the profile lacks a step kind: {kinds}")
    train = [x for i, x in enumerate(profile) if i % 4 != 3]
    hold = [x for i, x in enumerate(profile) if i % 4 == 3]
    est = BatchLatencyEstimator.fit([b for b, _ in train],
                                    [l for _, l in train])
    hold_b, hold_l = [b for b, _ in hold], np.array([l for _, l in hold])
    mape_fit = est.mape(hold_b, hold_l)
    lats = np.array([l for _, l in profile])
    floor = float(min(l for _, l in train))     # fitted on the train split
    ex = AnalyticalExecutor(QWEN1_5_0_5B_FP32,
                            InstanceHardware.h100(t_launch=floor))
    ex_ref = AnalyticalExecutor(QWEN1_5_0_5B_FP32, InstanceHardware.h100())

    def mape(pred):
        return float(np.mean(np.abs(pred - hold_l) / hold_l))

    pred = np.array([ex.batch_latency(b) for b in hold_b])
    pred_ref = np.array([ex_ref.batch_latency(b) for b in hold_b])
    mape_an, mape_an_ref = mape(pred), mape(pred_ref)
    if not all(np.isfinite(x) for x in (mape_fit, mape_an, mape_an_ref)):
        fail(f"sim: a MAPE is not finite: {mape_fit}, {mape_an}")
    print(f"  [{card}] sim: profiled {len(profile)} steps of the live "
          f"engine ({kinds}; {len(added)} requests, wall {wall:.3f} s, "
          f"step latency min {floor * 1e3:.3f} / median "
          f"{np.median(lats) * 1e3:.3f} / max {lats.max() * 1e3:.3f} ms); "
          f"{len(train)} fit, {len(hold)} held out", flush=True)
    print(f"  [{card}] sim: fitted estimator {est.as_dict()}, held-out "
          f"MAPE {mape_fit:.4f}", flush=True)
    for kind in ("decode", "mixed", "prefill"):
        sel = np.array([step_kind(b) == kind for b in hold_b])
        if sel.any():
            ratio = pred[sel] / hold_l[sel]
            print(f"  [{card}] sim: {kind} steps held out {int(sel.sum())}:"
                  f" measured median {np.median(hold_l[sel]) * 1e3:.3f} ms,"
                  f" H100 analytical / measured median "
                  f"{np.median(ratio):.4f}", flush=True)
    hw = ex.hw
    print(f"  [{card}] sim: H100 AnalyticalExecutor (Qwen1.5-0.5B fp32, "
          f"{hw.peak_flops_fp32 / 1e12:g} TFLOP/s fp32 x mfu {hw.mfu}, "
          f"{hw.hbm_bw / 1e12:g} TB/s x hbm_eff {hw.hbm_eff}, t_launch = "
          f"the training split's smallest measured step, "
          f"{floor * 1e3:.3f} ms): "
          f"held-out MAPE {mape_an:.4f}, predicted / measured median "
          f"{np.median(pred / hold_l):.4f}; with the reference's assumed "
          f"t_launch 3 ms: MAPE {mape_an_ref:.4f}, ratio "
          f"{np.median(pred_ref / hold_l):.4f}", flush=True)
    eng.kill()
    del eng

    def sim_once():
        trace = serve.replay_trace(serve.REPLAY)
        for i, r in enumerate(trace):
            r.rid = i
            r.arrival /= serve.REPLAY.speed      # the frontend's pace
        cs = ClusterSim(lambda: make_policy("slidebatching"),
                        GoRouting(est, RouterConfig(pd_mode="coloc")), ex,
                        est, EngineConfig(eta=1.0, w_p=serve.W_P, tau=1e9),
                        ClusterConfig(pd_mode="coloc", n_prefill=2,
                                      prefill_blocks=serve.REPLAY.num_blocks
                                      - 1))
        return replay_sim(cs, trace, w_p=serve.W_P)

    rep1, rep2 = sim_once(), sim_once()
    row1 = {k: v for k, v in rep1.row().items() if k != "wall_s"}
    row2 = {k: v for k, v in rep2.row().items() if k != "wall_s"}
    if row1 != row2:
        fail(f"sim: replay_sim rows differ: {row1} vs {row2}")
    if rep1.n_completed != rep1.n_submitted or rep1.n_rejected:
        fail(f"sim: replay_sim completed {rep1.n_completed} of "
             f"{rep1.n_submitted} ({rep1.n_rejected} rejected)")
    row1 = {k: (None if isinstance(v, float) and not np.isfinite(v)
                else v) for k, v in row1.items()}     # inf -> valid JSON
    print(f"  [{card}] sim: replay_sim of the frontend trace (2 coloc "
          f"replicas of {serve.REPLAY.num_blocks - 1} blocks, H100 "
          f"executor), identical twice: {json.dumps(row1)}", flush=True)
    return est, row1, params, counts


def frontend_phase(card: str, est, sim_row: dict, params, dev="cuda"):
    """``ServiceFrontend`` over torch replicas on the card (``launch/
    serve.py`` ``serve_frontend``, the path of ``--mode frontend``):
    64 requests of the industrial trace (3 priority classes, seed 1)
    replayed at 1000x, prompts clipped to 512 and outputs to 16 tokens,
    the SLOs of ``serve.PRIORITIES``, 160-block replicas; the router and
    the book use the estimator fitted in the sim phase.  (a) 2 coloc
    replicas; (b) 1 prefill + 2 decode replicas, fp32 wire; (c) 2 coloc
    replicas, replica 0 killed after its first token."""
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get("qwen1_5_0_5b")
    print(f"  replay {serve.REPLAY}", flush=True)
    passes = (("frontend (a)", dict(roles=("coloc", "coloc"),
                                    pd_mode="coloc")),
              ("frontend (b)", dict(roles=("prefill", "decode", "decode"),
                                    pd_mode="disagg")),
              ("frontend (c)", dict(roles=("coloc", "coloc"),
                                    pd_mode="coloc", kill=0)))
    out = {}
    for label, kw in passes:
        print(f"  -- {label}: {kw}", flush=True)
        fresh_peak()
        before = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        res = serve.serve_frontend(cfg, params, serve.REPLAY, seed=0,
                                   device=dev, est=est, **kw)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        s = res.summary()
        fe = res.frontend
        dead = [iid for iid, d in (*fe.drivers.items(),
                                   *fe.killed.items())
                if d.error is not None]
        if dead:
            fail(f"{label}: driver threads {dead} died")
        if not res.drained:
            fail(f"{label}: drain() did not return True")
        if s["completed"] != s["submitted"] or s["rejected"]:
            fail(f"{label}: {s['completed']} of {s['submitted']} streams "
                 f"complete, {s['rejected']} rejected")
        want = sum(r.output_len for r, _ in res.requests)
        for r, _ in res.requests:
            if len(res.outputs[r.rid]) != r.output_len:
                fail(f"{label}: rid {r.rid} streamed "
                     f"{len(res.outputs[r.rid])} tokens for {r.output_len}")
        if s["tokens_out"] != want:
            fail(f"{label}: the replicas emitted {s['tokens_out']} tokens "
                 f"for {want}")
        check_launches(res, counts, label)
        check_streams(res, label)
        if kw["pd_mode"] == "disagg":
            exp = sum(e.stats.handoffs_out for e in res.replicas
                      if e.role == "prefill")
            ado = sum(e.stats.handoffs_in for e in res.replicas
                      if e.role == "decode")
            crossing = sum(r.output_len > 1 for r, _ in res.requests)
            if not exp == ado == fe.book.handoffs == crossing:
                fail(f"{label}: exported {exp}, adopted {ado}, book "
                     f"{fe.book.handoffs}, requests crossing {crossing}")
            if fe.book.reservations:
                fail(f"{label}: reservations left {fe.book.reservations}")
        if kw.get("kill") is not None:
            if s["killed"] != [kw["kill"]] or not res.orphans:
                fail(f"{label}: killed {s['killed']}, "
                     f"{len(res.orphans)} orphans")
            short = [r.rid for r in res.orphans
                     if r.generated != r.output_len]
            if short:
                fail(f"{label}: orphans {short} did not complete")
        prios = sorted({r.priority for r, _ in res.requests})
        print(f"  [{card}] {label}: {s['completed']}/{s['submitted']} "
              f"streams exact in wall {s['wall_s']} s; TDG_Ratio "
              f"{s['tdg_ratio']}, SLO attainment {s['slo']}; replicas "
              f"{s['replicas']}; killed {s['killed']}, orphans "
              f"{s['orphans']}; max_memory_allocated {peak / 2**30:.3f} "
              f"GiB, {before / 2**30:.3f} GiB of it before the run",
              flush=True)
        for p in prios:
            print(f"  [{card}] {label}: priority {p}: TTFT p50 "
                  f"{s[f'ttft_p50_s_prio{p}']:.4f} / p99 "
                  f"{s[f'ttft_p99_s_prio{p}']:.4f} s, TPOT p50 "
                  f"{s[f'tpot_p50_s_prio{p}']:.4f} / p99 "
                  f"{s[f'tpot_p99_s_prio{p}']:.4f} s, TDG "
                  f"{s[f'tdg_p{p}']}, SLO {s[f'slo_p{p}']}", flush=True)
        busy = sum(s["busy_s"].values())
        print(f"  [{card}] {label}: step time summed over replicas "
              f"{busy:.3f} s = {busy / res.wall_s:.3f} x the wall "
              f"(one default stream); evictions {s['evictions']}, "
              f"prefill tokens {s['prefill_tokens']}, handoffs "
              f"{s['handoffs']} ({s['handoff_blocks']} blocks), "
              f"reservations hits {s['reservation_hits']} / misses "
              f"{s['reservation_misses']}", flush=True)
        print(f"  [{card}] {label} row: {json.dumps({k: s[k] for k in sim_row if k in s})}",
              flush=True)
        print(f"  [{card}] sim row:          {json.dumps(sim_row)}",
              flush=True)
        print(f"  launch counts {counts}", flush=True)
        out[label] = counts
        for eng in res.replicas:
            eng.kill()
        # an engine reaches its frontend (on_token -> driver -> sink), so
        # the next pass's peak counts its own pools only once all go
        del res, fe, eng
    return out


# --------------------------------------------------------------------------
# train phase: the training path at Qwen1.5-0.5B's full width
# --------------------------------------------------------------------------

TRAIN_ARCH = "qwen1_5_0_5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512
# Adam moves each weight ~lr a step: at full width 1e-3 takes the loss of
# three cycled batches below 0.9x its first value within 12 steps
TRAIN_LR = 1e-3
TRAIN_STEPS = 12
# (a) runs the step on this machine's CPU as well: 2 x 256 tokens (cut
# from 8 x 512 by the CPU's time), full width and depth
CARD_CPU_BATCH, CARD_CPU_SEQ = 2, 256
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-4          # (a): of each leaf's max |g|
ACCUM_PARAM_ATOL = 1e-4        # (c): tests/test_training.py's
# (c): AdamW's first step moves a weight by ~lr * sign(g) whatever |g|
# (m / sqrt(v) = g / |g|), so where a gradient entry is at fp32 noise
# (within 1e-5 of its leaf's max |g|, about (a)'s card / CPU agreement)
# the two summation orders may step it either way: those entries (11 of
# 620 M in the first card runs, all with |g| <= 6.4e-7 of their leaf's
# max) are held to 2 lr, the most two first steps can differ by
ACCUM_NOISE_REL = 1e-5
REMAT_GRAD_REL = 1e-6          # (d): of each leaf's max |g|
RESTART_ATOL = 1e-6            # (f): tests/test_training.py:126
RESTART_STEPS = (2, 4)         # (f): checkpoint after 2 of 4 steps
# (g): (arch, batch, seq, layers kept (None: all), steps), remat on, at
# FAMILY_LR: these deep stacks at init overshoot with Adam's first steps
# (at 1e-3 one step took Mamba2's loss from 11.29 to 16.42; at 1e-4
# Hymba's rose 10.70 -> 15.22 in 3 steps, at 3e-5 10.70 -> 8.25 ->
# 11.42; at 1e-5 all four fell every step).  OLMoE: 4 of 16 layers (its
# full training state is ~138 GB).  Whisper: its decoder's 448 positions
# over the 1500 stub frames.
FAMILY_LR = 1e-5
TRAIN_FAMILIES = (("olmoe_1b_7b", 8, 512, 4, 3),
                  ("mamba2_1_3b", 8, 512, None, 3),
                  ("hymba_1_5b", 8, 512, None, 3),
                  ("whisper_small", 8, 448, None, 3))
# The SSD chunk of (g)'s Mamba2 and Hymba.  Within a chunk the
# reference's _segsum_decay takes exp of up to the chunk's summed dt,
# which passes 88.7 (fp32 overflow) from ~64 tokens at these widths, and
# its backward then turns inf into NaN (ROADMAP Queue 3 item 8): with the
# configs' 256 no step past ~64 tokens has a finite gradient, in either
# package.  A frequent token repeats its dt down a chunk, so even chunks
# of 32 reached an exponent of 52 on two full-width Hymba layers (and
# NaN at 32 layers on the card).  Chunking is exact: 16-token chunks
# compute the same function and gradient (chunk 32 was 4.4e-6 of a
# leaf's max |g| from 256 where 256 is finite, on the CPU), with
# exponents of at most 15 dt; (g) also prints the configs' chunk's
# non-finite gradient leaves, not gated
FAMILY_SSM_CHUNK = 16


def named_leaves(tree: dict, prefix: str = ""):
    """(path, tensor) in the tree's flattening order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def max_abs_diff(a: dict, b: dict) -> float:
    return max(float((x - y.to(x.device)).abs().max()) for (_, x), (_, y)
               in zip(named_leaves(a), named_leaves(b)))


def train_flops(cfg, params: dict, batch: int, seq: int) -> float:
    """One step's operations: 6 N T over the matmul weights (every layer
    leaf and lm_head; the embedding is a gather), plus the attention's
    score and value products over the full S x S tile the dense core
    computes, 4 B S^2 H hd per layer forward, three times with the
    backward."""
    n = sum(t.numel() for t in iter_leaves(params["layers"])) \
        + params["lm_head"].numel()
    attn = 4 * batch * seq * seq * cfg.n_heads * cfg.hd * cfg.n_layers
    return 6.0 * n * batch * seq + 3.0 * attn


def grad_diagnosis(card: str, grad_fn, params: dict, host: dict,
                   batch_dev: dict, batch_cpu: dict, g_c: dict,
                   g_h: dict) -> None:
    """Train (a)'s diagnosis (ROADMAP Queue 3 item 9), printed before its
    gate and not gated: this machine's CPU, threads, BLAS and fp32
    matmul settings; each side's gradients against a float64 run of the
    same step on the CPU (the model's own fp32 casts, in the norms, the
    attention scores and the loss, stay fp32 there), per leaf, `embed`
    named; and whether each side repeats its own gradients."""
    from repro_torch.models.convert import params_from_numpy, params_to_numpy

    cpu = "unknown CPU"
    flags = ""
    info = Path("/proc/cpuinfo")
    if info.exists():
        text = info.read_text()
        found = re.search(r"model name\s*:\s*(.+)", text)
        cpu = found.group(1).strip() if found else cpu
        found = re.search(r"flags\s*:\s*(.+)", text)
        have = set(found.group(1).split()) if found else set()
        flags = " ".join(f for f in ("avx512f", "avx512_bf16", "amx_bf16",
                                     "amx_tile") if f in have)
    blas = re.findall(r"(?:BLAS|LAPACK)_INFO=\w+", torch.__config__.show())
    mkldnn = getattr(getattr(torch.backends.mkldnn, "matmul", None),
                     "fp32_precision", "n/a")
    print(f"  [{card}] train (a) CPU: {cpu} ({flags or 'no avx512/amx'}); "
          f"{torch.get_num_threads()} threads; {' '.join(blas)}; "
          f"float32_matmul_precision "
          f"{torch.get_float32_matmul_precision()}, mkldnn matmul "
          f"{mkldnn}, cuda allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; "
          f"{' '.join(torch.__config__.parallel_info().split())}",
          flush=True)
    host64 = params_from_numpy(params_to_numpy(params), device="cpu",
                               dtype=torch.float64)
    t0 = time.monotonic()
    _, g_64 = grad_fn(host64, *batch_cpu.values())
    t_64 = time.monotonic() - t0
    _, g_c2 = grad_fn(params, *batch_dev.values())
    _, g_h2 = grad_fn(host, *batch_cpu.values())
    rows = {}
    for side, g, again in (("card", g_c, g_c2), ("CPU", g_h, g_h2)):
        worst, worst_name, embed, rep = 0.0, "", 0.0, 0.0
        for (name, x), (_, y), (_, z) in zip(named_leaves(g),
                                             named_leaves(g_64),
                                             named_leaves(again)):
            x = x.cpu()
            rel = float((x.double() - y).abs().max()) / max(
                float(y.abs().max()), 1e-30)
            rep = max(rep, float((z.cpu() - x).abs().max()))
            if name == "embed":
                embed = rel
            if rel > worst:
                worst, worst_name = rel, name
        rows[side] = (f"{side}: embed {embed:.3e}, worst leaf "
                      f"{worst_name} {worst:.3e} of its max |g|, a second "
                      f"run within {rep:.3e}")
    print(f"  [{card}] train (a) gradients against float64 on the CPU "
          f"({t_64:.1f} s): {rows['card']}; {rows['CPU']}", flush=True)


def train_phase(card: str, dev="cuda") -> None:
    """The training path (``repro_torch.training`` through
    ``models.model.forward_train``, ``launch/train.py``'s loop) at
    Qwen1.5-0.5B's full published width and depth, fp32, TF32 off, random
    weights from seed 0; then the other families.  No CUDA kernel of the
    port lies on this path (plain autograd, as the reference)."""
    import tempfile
    from statistics import median

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.model import init_params
    from repro_torch.training import (CheckpointManager, TokenPipeline,
                                      adamw_update, init_adamw,
                                      make_train_step)
    from repro_torch.training.train import make_loss_fn, value_and_grad

    t_phase = time.monotonic()
    ops.reset_launch_counts()
    cfg = get(TRAIN_ARCH)

    def on(b: dict, where) -> dict:
        return {k: torch.as_tensor(v).to(where) for k, v in b.items()}

    def fresh(seed: int = 0):
        return init_params(cfg, torch.Generator(dev).manual_seed(seed),
                           device=dev)

    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    # (a) one step on the card and on this machine's CPU, same weights
    t0 = time.monotonic()
    params = fresh()
    n_params = sum(t.numel() for t in iter_leaves(params))
    host = params_from_numpy(params_to_numpy(params), device="cpu")
    b = TokenPipeline(cfg.vocab, CARD_CPU_BATCH, CARD_CPU_SEQ,
                      seed=0).batch_at(0)
    grad_fn = value_and_grad(make_loss_fn(cfg, remat=False))
    loss_c, g_c = grad_fn(params, *on(b, dev).values())
    torch.cuda.synchronize()
    t1 = time.monotonic()
    loss_h, g_h = grad_fn(host, *on(b, "cpu").values())
    t_cpu = time.monotonic() - t1
    grad_diagnosis(card, grad_fn, params, host, on(b, dev), on(b, "cpu"),
                   g_c, g_h)
    loss_c, loss_h = float(loss_c), float(loss_h)
    if not abs(loss_c - loss_h) <= TRAIN_LOSS_RTOL * abs(loss_h):
        fail(f"train (a): loss {loss_c} on the card, {loss_h} on the CPU")
    worst, worst_name, over = 0.0, "", []
    for (name, x), (_, y) in zip(named_leaves(g_c), named_leaves(g_h)):
        x = x.cpu()
        if not torch.isfinite(x).all():
            fail(f"train (a): non-finite gradient of {name} on the card")
        scale, err = float(y.abs().max()), float((x - y).abs().max())
        if not err <= TRAIN_GRAD_REL * scale:
            over.append(f"{name} {err:.3e} of max |g| {scale:.3e}")
        if scale > 0 and err / scale > worst:
            worst, worst_name = err / scale, name
    if over:
        fail(f"train (a): gradients beyond {TRAIN_GRAD_REL} x max |g|: "
             + "; ".join(over))
    p_c, _ = adamw_update(g_c, init_adamw(params), params, lr=TRAIN_LR)
    p_h, _ = adamw_update(g_h, init_adamw(host), host, lr=TRAIN_LR)
    step_diff = max_abs_diff(p_h, p_c)
    print(f"  [{card}] train (a) {cfg.name}, full width and depth "
          f"({cfg.n_layers} layers, {n_params} fp32 parameters), batch "
          f"{CARD_CPU_BATCH} x {CARD_CPU_SEQ}: loss card {loss_c:.7f}, "
          f"CPU {loss_h:.7f} (rel {TRAIN_LOSS_RTOL}); worst gradient leaf "
          f"{worst_name} at {worst:.3e} of its max |g| (gate "
          f"{TRAIN_GRAD_REL}); params after one AdamW step (lr "
          f"{TRAIN_LR}) within {step_diff:.3e} (not gated: entries with "
          f"gradients at fp32 noise move ~lr either way, see (c)); CPU "
          f"value_and_grad "
          f"{t_cpu:.1f} s; (a) {time.monotonic() - t0:.1f} s", flush=True)
    del params, host, g_c, g_h, p_c, p_h
    release()

    # (b) the launcher's loop: loss descends over three cycled batches
    fresh_peak()
    res = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                lr=TRAIN_LR, device=dev, cycle=3, verbose=False)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    if not losses[-1] < 0.9 * losses[0]:
        fail(f"train (b): loss {losses[0]:.4f} -> {losses[-1]:.4f}, not "
             "below 0.9x")
    step_s = median(res["step_s"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, res["params"], TRAIN_BATCH, TRAIN_SEQ)
    print(f"  [{card}] train (b) {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} (3 batches cycled, lr {TRAIN_LR}, remat off): "
          f"loss {' '.join(f'{x:.4f}' for x in losses)}; step "
          f"{step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
          f"{res['step_s'][0] * 1e3:.1f} ms), {tokens / step_s:.0f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP a step = "
          f"{flops / step_s / 1e12:.2f} TFLOP/s, "
          f"{100 * flops / step_s / FP32_FLOPS_PER_S:.1f} % of the fp32 "
          f"peak; max_memory_allocated {peak / 2**30:.2f} GiB",
          flush=True)
    del res
    release()

    # (c) grad accumulation: microbatches 2 = 1 on one global batch
    params = fresh()
    b = on(TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                         seed=1).batch_at(0), dev)
    outs = {}
    for mb in (1, 2):
        step = make_train_step(cfg, remat=False, lr=TRAIN_LR,
                               microbatches=mb)
        p2, _, m = step(params, init_adamw(params), b)
        outs[mb] = (float(m["loss"]), float(m["grad_norm"]), p2)
        del p2, m
        release()
    (l1, n1, p1), (l2, n2, p2) = outs[1], outs[2]
    if not abs(l1 - l2) <= TRAIN_LOSS_RTOL * abs(l1) \
            or not abs(n1 - n2) <= TRAIN_LOSS_RTOL * abs(n1):
        fail(f"train (c): microbatches 2 vs 1: loss {l2} vs {l1}, grad "
             f"norm {n2} vs {n1}")
    _, g1 = value_and_grad(make_loss_fn(cfg, remat=False))(
        params, b["tokens"], b["labels"])
    d, d_kept, noisy = 0.0, 0.0, 0
    for (name, x), (_, y), (_, g) in zip(named_leaves(p1), named_leaves(p2),
                                         named_leaves(g1)):
        diff = (x - y).abs()
        off = diff > ACCUM_PARAM_ATOL
        d = max(d, float(diff.max()))
        if not off.all():
            d_kept = max(d_kept, float(diff[~off].max()))
        if off.any():
            g_off = float(g[off].abs().max())
            g_max = float(g.abs().max())
            if not (g_off <= ACCUM_NOISE_REL * g_max
                    and float(diff.max()) <= 2 * TRAIN_LR):
                fail(f"train (c): {name}: {int(off.sum())} entries beyond "
                     f"{ACCUM_PARAM_ATOL} (max {float(diff.max()):.3e}) "
                     f"with |g| up to {g_off:.3e} of max |g| {g_max:.3e}")
            noisy += int(off.sum())
    print(f"  [{card}] train (c) microbatches 2 vs 1 on {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: loss {l2:.7f} vs {l1:.7f}, grad norm {n2:.7f} vs "
          f"{n1:.7f} (rel {TRAIN_LOSS_RTOL}); params within {d_kept:.3e} "
          f"(gate {ACCUM_PARAM_ATOL}) but {noisy} entries with gradients at "
          f"fp32 noise (<= {ACCUM_NOISE_REL} of their leaf's max |g|), "
          f"within {d:.3e} (gate 2 lr = {2 * TRAIN_LR})", flush=True)
    del outs, p1, p2, g1
    release()

    # (d) remat: the same gradients, less activation memory
    grads, peaks = {}, {}
    for remat in (False, True):
        fresh_peak()
        base = torch.cuda.memory_allocated()
        _, g = value_and_grad(make_loss_fn(cfg, remat=remat))(
            params, b["tokens"], b["labels"])
        torch.cuda.synchronize()
        # above the weights, the batch and the other run's gradients
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        grads[remat] = g
        del g
    bitwise, worst = True, 0.0
    for (name, x), (_, y) in zip(named_leaves(grads[True]),
                                 named_leaves(grads[False])):
        bitwise = bitwise and torch.equal(x, y)
        scale, err = float(y.abs().max()), float((x - y).abs().max())
        if not err <= REMAT_GRAD_REL * scale:
            fail(f"train (d): remat gradient of {name} off by {err:.3e} "
                 f"(max |g| {scale:.3e})")
        worst = max(worst, err / scale if scale > 0 else 0.0)
    print(f"  [{card}] train (d) remat on vs off, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: gradients bitwise equal: {bitwise} (worst leaf "
          f"{worst:.3e} of its max |g|, gate {REMAT_GRAD_REL}); "
          f"max_memory_allocated above the weights and batch: remat off "
          f"{peaks[False] / 2**30:.2f} GiB, on {peaks[True] / 2**30:.2f} "
          f"GiB (saves {(peaks[False] - peaks[True]) / 2**30:.2f} GiB)",
          flush=True)
    del grads, params, b
    release()

    # (e) int8 error-feedback compression converges
    res = train(cfg, steps=10, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                lr=TRAIN_LR, device=dev, cycle=2, compress_grads=True,
                verbose=False)
    losses = res["losses"]
    if not losses[-1] < losses[0]:
        fail(f"train (e): compressed loss {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}")
    print(f"  [{card}] train (e) compress_grads, 10 steps (2 batches "
          f"cycled): loss {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    del res
    release()

    # (f) crash and restart from an async checkpoint
    k, n = RESTART_STEPS
    step = make_train_step(cfg, remat=False, lr=TRAIN_LR)
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=2)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="train_ckpt_",
                                     dir=ROOT / "build") as ckdir:
        p = fresh()
        o = init_adamw(p)
        for i in range(k):
            p, o, _ = step(p, o, on(pipe.batch_at(i), dev))
        mgr = CheckpointManager(ckdir, keep=2)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mgr.save_async(k, {"p": p, "o": o})
        t_copy = time.monotonic() - t0
        for i in range(k, n):                 # trains while it writes
            p, o, _ = step(p, o, on(pipe.batch_at(i), dev))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mgr.wait()
        t_wait = time.monotonic() - t0
        p2 = fresh(1)                         # fresh tensors, other values
        t0 = time.monotonic()
        restored, at = mgr.restore({"p": p2, "o": init_adamw(p2)})
        t_restore = time.monotonic() - t0
        del p2
        ck_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*")
                       if f.is_file())
    if at != k:
        fail(f"train (f): restored step {at}, saved {k}")
    p3, o3 = restored["p"], restored["o"]
    del restored
    for i in range(at, n):
        p3, o3, _ = step(p3, o3, on(pipe.batch_at(i), dev))
    d = max(max_abs_diff(p, p3), max_abs_diff(o.mu, o3.mu),
            max_abs_diff(o.nu, o3.nu), max_abs_diff(o.master, o3.master))
    same = all(torch.equal(x, y) for (_, x), (_, y) in
               zip(named_leaves(p), named_leaves(p3)))
    if not d <= RESTART_ATOL or int(o3.step) != n:
        fail(f"train (f): restarted run off by {d:.3e} (step {int(o3.step)})")
    print(f"  [{card}] train (f) {k} steps, save_async, {n - k} more, "
          f"restore into fresh tensors, the same {n - k} again: params and "
          f"moments within {d:.3e} (atol {RESTART_ATOL}), params bitwise "
          f"equal: {same}; checkpoint {ck_bytes / 2**30:.2f} GiB, "
          f"save_async's host copy {t_copy:.2f} s, write left after "
          f"{n - k} steps {t_wait:.2f} s, restore {t_restore:.2f} s",
          flush=True)
    del p, o, p3, o3
    release()

    train_families(card, dev)
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"train: a serving kernel launched on the training path: "
             f"{counts}")
    print(f"  [{card}] train: no CUDA kernel of the port launched "
          f"({sum(counts.values())} launches); phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)


def train_families(card: str, dev="cuda") -> None:
    """The train phase's (g): the other families at full width, a few
    steps on one batch, remat on."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    from repro_torch.training import (TokenPipeline, init_adamw,
                                      make_train_step)
    from repro_torch.training.train import make_loss_fn, value_and_grad

    for arch, bsz, seq, n_layers, n_steps in TRAIN_FAMILIES:
        fresh_peak()
        t0 = time.monotonic()
        fcfg = get(arch)
        if n_layers is not None:
            fcfg = dataclasses.replace(fcfg, n_layers=n_layers)
        params = init_params(fcfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        n_p = sum(t.numel() for t in iter_leaves(params))
        b = {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
            fcfg.vocab, bsz, seq, seed=0, enc_frames=fcfg.enc_frames,
            d_model=fcfg.d_model).batch_at(0).items()}
        note = ""
        if fcfg.family in ("ssm", "hybrid"):
            _, g = value_and_grad(make_loss_fn(fcfg, remat=True))(
                params, b["tokens"], b["labels"])
            bad = sum(not bool(torch.isfinite(t).all())
                      for t in iter_leaves(g))
            note = (f"; SSD chunk {FAMILY_SSM_CHUNK} (at the config's "
                    f"{fcfg.ssm_chunk}: {bad} of {len(list(iter_leaves(g)))} "
                    "gradient leaves non-finite, the reference's "
                    "_segsum_decay)")
            del g
            fcfg = dataclasses.replace(fcfg, ssm_chunk=FAMILY_SSM_CHUNK)
        opt = init_adamw(params)
        step = make_train_step(fcfg, remat=True, lr=FAMILY_LR)
        losses, norms, times = [], [], []
        for _ in range(n_steps):
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t1)
            norms.append(float(m["grad_norm"]))
        # a finite global norm: every gradient entry finite
        if not all(np.isfinite(losses + norms)):
            fail(f"train (g) {arch}: loss {losses}, grad norm {norms}")
        if not losses[-1] < losses[0]:
            fail(f"train (g) {arch}: loss {losses}")
        frames = (f" + {fcfg.enc_frames} frames" if fcfg.enc_frames
                  else "")
        print(f"  [{card}] train (g) {fcfg.name} ({fcfg.family}, "
              f"{fcfg.n_layers} layers, {n_p} parameters), {bsz} x "
              f"{seq}{frames}, remat: loss "
              f"{' '.join(f'{x:.4f}' for x in losses)}, grad norm "
              f"{' '.join(f'{x:.3f}' for x in norms)} (lr {FAMILY_LR}); "
              f"step {times[-1] * 1e3:.1f} ms (last); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{time.monotonic() - t0:.1f} s{note}", flush=True)
        del params, opt, b, m
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# mesh: the sharded steps of launch/steps.py on a one-rank mesh
# --------------------------------------------------------------------------

MESH_ARCH = "qwen1_5_0_5b"
# reduced SHAPES that one card holds beside the unsharded run: prefill
# 4 x 2048 (prefill_32k: 32 x 32768); decode 8 rows against a
# 2048-position cache holding a 1024-token prompt, 16 greedy tokens
# (decode_32k: 128 x 32768); train 8 x 512, the train phase's batch
# (train_4k: 256 x 4096)
MESH_PREFILL = ("prefill_2k", "prefill", 2048, 4)
MESH_DECODE = ("decode_2k", "decode", 2048, 8)
MESH_PROMPT, MESH_GREEDY = 1024, 16
MESH_TRAIN = ("train_512", "train", TRAIN_SEQ, TRAIN_BATCH)


def full_tensor(x) -> torch.Tensor:
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def same(got, want) -> tuple[float, bool]:
    """(max |got - want|, bitwise equal) of a DTensor and a tensor."""
    got = full_tensor(got)
    return float((got - want).abs().max()), bool(torch.equal(got, want))


def mesh_phase(card: str, dev="cuda") -> None:
    """``launch/steps.py``'s sharded prefill, serve and train steps on a
    one-rank world (NCCL on the card) and a (1, 1) ``("data", "model")``
    ``DeviceMesh``, at Qwen1.5-0.5B's full published width and depth,
    fp32, parameters from ``init_params`` (seed 0), each against the
    unsharded port function on the same card.  No kernel of the port lies
    on this path (the reference's steps run chunked / decode attention
    and the loss in plain JAX)."""
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.training import (TokenPipeline, init_adamw,
                                      make_train_step)

    t_phase = time.monotonic()
    ops.reset_launch_counts()
    cfg = get(MESH_ARCH)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"),
                               device_type=torch.device(dev).type)
        serve_pol = ShardingPolicy(mesh, mode="serve")
        params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        rng = torch.Generator(dev).manual_seed(11)

        def timed(fn, *args):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*args)
            torch.cuda.synchronize()
            return out, time.monotonic() - t0

        # prefill: last-position logits and the cache
        fresh_peak()
        shape = steps.ShapeSpec(*MESH_PREFILL)
        step, _, _ = steps.build_prefill_step(cfg, serve_pol, shape,
                                              device=dev)
        toks = torch.randint(0, cfg.vocab, (shape.batch, shape.seq),
                             generator=rng, device=dev)
        p_sh = steps.place(params, step.in_shardings[0])
        (logits_s, cache_s), t_first = timed(step, p_sh, toks)
        (logits_s, cache_s), t_s = timed(step, p_sh, toks)
        (logits_1, cache_1), t_1 = timed(
            lambda: prefill(cfg, params, toks, max_seq=shape.seq,
                            attn_impl="chunked"))
        peak = torch.cuda.max_memory_allocated()
        err, bit = same(logits_s, logits_1)
        c_err, c_bit = 0.0, True
        for k in cache_1:
            e, b = same(cache_s[k], cache_1[k])
            c_err, c_bit = max(c_err, e), c_bit and b
        if not (err <= TOL["atol"] and c_err <= TOL["atol"]):
            fail(f"mesh prefill: logits off by {err:.3e}, cache by "
                 f"{c_err:.3e}")
        print(f"  [{card}] mesh prefill {cfg.name} {shape.batch} x "
              f"{shape.seq}: logits within {err:.3e} (bitwise {bit}), "
              f"cache within {c_err:.3e} (bitwise {c_bit}), atol "
              f"{TOL['atol']}; sharded step {t_s * 1e3:.1f} ms (first call "
              f"{t_first * 1e3:.1f} ms), unsharded {t_1 * 1e3:.1f} ms; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
        del logits_s, cache_s, logits_1, cache_1, p_sh, step
        gc.collect()
        torch.cuda.empty_cache()

        # serve: greedy decode from a prefilled cache, each side choosing
        # its own tokens
        fresh_peak()
        shape = steps.ShapeSpec(*MESH_DECODE)
        step, _, _ = steps.build_serve_step(cfg, serve_pol, shape,
                                            device=dev)
        prompt = torch.randint(0, cfg.vocab, (shape.batch, MESH_PROMPT),
                               generator=rng, device=dev)
        logits_1, cache_1 = prefill(cfg, params, prompt, max_seq=shape.seq,
                                    attn_impl="chunked")
        cache_s = steps.place({k: v.clone() for k, v in cache_1.items()},
                              step.in_shardings[1])
        p_sh = steps.place(params, step.in_shardings[0])
        tok_s = tok_1 = logits_1.argmax(-1)
        errs, bits, toks_s, toks_1, t_s, t_1 = [], [], [], [], [], []
        for _ in range(MESH_GREEDY):
            (logits_s, cache_s), dt = timed(step, p_sh, cache_s, tok_s)
            t_s.append(dt)
            (logits_1, cache_1), dt = timed(decode_step, cfg, params,
                                            cache_1, tok_1)
            t_1.append(dt)
            e, b = same(logits_s, logits_1)
            errs.append(e)
            bits.append(b)
            tok_s = full_tensor(logits_s).argmax(-1)
            tok_1 = logits_1.argmax(-1)
            toks_s.append(tok_s)
            toks_1.append(tok_1)
        peak = torch.cuda.max_memory_allocated()
        toks_s, toks_1 = torch.stack(toks_s, 1), torch.stack(toks_1, 1)
        c_err, c_bit = 0.0, True
        for k in cache_1:
            e, b = same(cache_s[k], cache_1[k])
            c_err, c_bit = max(c_err, e), c_bit and b
        if not torch.equal(toks_s, toks_1):
            fail(f"mesh serve: greedy tokens differ: {toks_s.tolist()} vs "
                 f"{toks_1.tolist()}")
        if not (max(errs) <= TOL["atol"] and c_err <= TOL["atol"]):
            fail(f"mesh serve: logits off by {max(errs):.3e}, cache by "
                 f"{c_err:.3e}")
        print(f"  [{card}] mesh serve {cfg.name} {shape.batch} rows, "
              f"{MESH_PROMPT}-token prompts in a {shape.seq}-position "
              f"cache, {MESH_GREEDY} greedy tokens: tokens equal; logits "
              f"within {max(errs):.3e} (bitwise in {sum(bits)} of "
              f"{len(bits)} steps), cache within {c_err:.3e} (bitwise "
              f"{c_bit}), atol {TOL['atol']}; sharded step "
              f"{np.median(t_s[1:]) * 1e3:.1f} ms (median; first "
              f"{t_s[0] * 1e3:.1f} ms), unsharded "
              f"{np.median(t_1[1:]) * 1e3:.1f} ms; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del logits_s, cache_s, logits_1, cache_1, p_sh, step
        gc.collect()
        torch.cuda.empty_cache()

        # train: one step; AdamW's first moment after one step from zero
        # is (1 - b1) x the clipped gradient, so each leaf of mu within
        # 1e-4 of its largest entry is the train phase's gradient gate
        fresh_peak()
        train_pol = ShardingPolicy(mesh, mode="train")
        shape = steps.ShapeSpec(*MESH_TRAIN)
        step, _, meta = steps.build_train_step(cfg, train_pol,
                                               microbatches=1, device=dev)
        b = {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
            cfg.vocab, shape.batch, shape.seq, seed=3).batch_at(0).items()}
        one = make_train_step(cfg, attn_impl="chunked", remat=True,
                              microbatches=meta["microbatches"])
        (p_1, o_1, m_1), t_1 = timed(one, params, init_adamw(params), b)
        mu_1 = o_1.mu
        del o_1
        gc.collect()
        p_sh = steps.place(params, step.in_shardings[0])
        o_sh = steps.place(init_adamw(params), step.in_shardings[1])
        (p_s, o_s, m_s), t_first = timed(step, p_sh, o_sh, b)
        del p_s, o_s
        (p_s, o_s, m_s), t_s = timed(step, p_sh, o_sh, b)
        peak = torch.cuda.max_memory_allocated()
        loss_s, loss_1 = float(full_tensor(m_s["loss"])), float(m_1["loss"])
        if not abs(loss_s - loss_1) <= TRAIN_LOSS_RTOL * abs(loss_1):
            fail(f"mesh train: loss {loss_s} sharded, {loss_1} unsharded")
        worst, worst_name, g_bit = 0.0, "", True
        for (name, x), (_, y) in zip(named_leaves(o_s.mu),
                                     named_leaves(mu_1)):
            err, bit = same(x, y)
            scale = float(y.abs().max())
            g_bit = g_bit and bit
            if not err <= TRAIN_GRAD_REL * scale:
                fail(f"mesh train: gradient of {name} off by {err:.3e} "
                     f"(max {scale:.3e})")
            if scale > 0 and err / scale > worst:
                worst, worst_name = err / scale, name
        p_err, p_bit = 0.0, True
        for (_, x), (_, y) in zip(named_leaves(p_s), named_leaves(p_1)):
            e, bit = same(x, y)
            p_err, p_bit = max(p_err, e), p_bit and bit
        print(f"  [{card}] mesh train {cfg.name} {shape.batch} x "
              f"{shape.seq} (remat, chunked attention, microbatches "
              f"{meta['microbatches']}): loss {loss_s:.7f} vs {loss_1:.7f} "
              f"(rel {TRAIN_LOSS_RTOL}, bitwise {loss_s == loss_1}); "
              f"gradients bitwise {g_bit}, worst leaf "
              f"{worst_name or 'none'} at {worst:.3e} of its max |g| (gate "
              f"{TRAIN_GRAD_REL}); params "
              f"after the step within {p_err:.3e} (bitwise {p_bit}; not "
              f"gated); sharded step {t_s * 1e3:.1f} ms (first call "
              f"{t_first * 1e3:.1f} ms), unsharded {t_1 * 1e3:.1f} ms; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
        del p_s, o_s, m_s, p_1, mu_1, p_sh, o_sh, params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"mesh: a serving kernel launched on the sharded steps: "
             f"{counts}")
    print(f"  [{card}] mesh: process group destroyed; no CUDA kernel of "
          f"the port launched ({sum(counts.values())} launches)",
          flush=True)
    mesh_worlds_part(card)
    print(f"  [{card}] mesh: phase {time.monotonic() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------------------
# mesh, more ranks: the sharded steps on multi-rank meshes, on the CPU
# --------------------------------------------------------------------------

# The card's gloo cannot carry DTensor's all-gather of CUDA tensors (the
# functional all-gather, ``_c10d_functional.all_gather_into_tensor``,
# kills the process with a segmentation fault under torch 2.11; all-reduce,
# reduce-scatter and all-to-all pass), and NCCL refuses two ranks on one
# device: no multi-rank mesh runs on the one card.  What the multi-rank
# path needs from this machine is its torch, so the (1, 2) and (1, 4)
# gloo worlds of ``tests/_torch_dist_worker.py`` run here as CPU
# processes, side by side:
# SMOKE dense and MoE on (1, 2); SMOKE GQA (2 kv heads on 4 ranks), the
# same with 6 heads (the query rows split) and the SMOKE hybrid on (1, 4)
MESH_WORLDS = {"steps-1x2": 2, "steps-1x4": 4}
MESH_WORLDS_LIMIT_S = 300
# tests/test_torch_dist.py's tolerances
WORLD_TOL = {"logits_abs": 2e-5, "cache_abs": 2e-5, "loss_rel": 1e-5,
             "grad_norm_rel": 1e-5, "grad_rel": 1e-4, "nu_rel": 1e-4,
             "param_abs": 1e-4}


def world_errors(res: dict) -> dict:
    """One rank's worst error per gate over its cases, and its faults:
    a shard fault, a ``_StridedShard`` DTensor, a greedy token that
    differs, a restore that is not the same step."""
    worst = dict.fromkeys(WORLD_TOL, 0.0)
    faults = []
    for case, r in res.items():
        t = r["train"]
        for key, (got, want) in (("loss_rel", t["loss"]),
                                 ("grad_norm_rel", t["grad_norm"])):
            worst[key] = max(worst[key], abs(got - want) / abs(want))
        for key in ("grad_rel", "nu_rel", "param_abs"):
            worst[key] = max(worst[key], t[key])
        for part in ("prefill", "serve"):
            for key in ("logits_abs", "cache_abs"):
                worst[key] = max(worst[key], r[part][key])
        if r["serve"]["tokens"][0] != r["serve"]["tokens"][1]:
            faults.append(f"{case}: greedy tokens differ")
        if r["restore"]["param_abs"] != 0.0:
            faults.append(f"{case}: the restored step differs")
        for step, sr in r.items():
            faults += [f"{case} {step}: {f}" for f in sr["shard_faults"]]
            faults += [f"{case} {step}: strided {f}" for f in sr["strided"]]
    return {"worst": worst, "faults": faults}


def mesh_worlds_part(card: str) -> None:
    """The multi-rank worlds (``MESH_WORLDS``) as CPU processes under this
    machine's torch, meeting through ``FileStore``s in a fresh temporary
    directory, within ``MESH_WORLDS_LIMIT_S``; every rank of every case
    within ``WORLD_TOL`` of one process, with no fault."""
    import tempfile

    print(f"  [{card}] mesh, more ranks: on the CPU, not the card "
          f"(gloo cannot all-gather CUDA tensors for DTensor here): "
          f"{', '.join(MESH_WORLDS)} of tests/_torch_dist_worker.py, torch "
          f"{torch.__version__}", flush=True)
    t0 = time.monotonic()
    tmp = Path(tempfile.mkdtemp(prefix="mesh_worlds_"))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    for job, size in MESH_WORLDS.items():
        (tmp / job).mkdir()
        procs[job] = [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
             job, str(r), str(size), str(tmp / job / "store"),
             str(tmp / job)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT)
            for r in range(size)]
    for job, ranks in procs.items():
        for r, p in enumerate(ranks):
            left = MESH_WORLDS_LIMIT_S - (time.monotonic() - t0)
            try:
                log, _ = p.communicate(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                    q.communicate()
                fail(f"mesh {job}: passed the {MESH_WORLDS_LIMIT_S} s limit")
            if p.returncode != 0:
                fail(f"mesh {job} rank {r} exited {p.returncode}:\n"
                     f"{log.decode(errors='replace')[-4000:]}")
        wall = time.monotonic() - t0
        errs = [world_errors(json.loads(
            (tmp / job / f"rank{r}.json").read_text()))
            for r in range(len(ranks))]
        worst = {k: max(e["worst"][k] for e in errs) for k in WORLD_TOL}
        faults = [f for e in errs for f in e["faults"]]
        cases = json.loads((tmp / job / "rank0.json").read_text())
        print(f"  [{card}] mesh {job} ({len(ranks)} CPU ranks; "
              f"{', '.join(cases)}): worst "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f"; faults {len(faults)}; done {wall:.1f} s after the start",
              flush=True)
        if faults:
            fail(f"mesh {job}: {faults[:5]}")
        bad = {k: v for k, v in worst.items() if not v <= WORLD_TOL[k]}
        if bad:
            fail(f"mesh {job}: beyond {WORLD_TOL}: {bad}")


# --------------------------------------------------------------------------
# dryrun: launch/dryrun.py's prediction held to the card's own step
# --------------------------------------------------------------------------

DRYRUN_TIMED = 5               # timed steps after the warm-up (median)
DRYRUN_PEAK_SHARE = 0.95       # measured peak / predicted peak, at least


def dryrun_inputs(kind: str, structs: tuple, params: dict, cfg,
                  dev) -> tuple:
    """The card's inputs for a step whose stand-ins are ``structs``: the
    parameters from ``init_params``, the rest drawn to the stand-ins'
    shapes and dtypes (seed 5)."""
    from repro_torch.training import TokenPipeline, init_adamw

    g = torch.Generator(dev).manual_seed(5)

    def tokens(like):
        return torch.randint(0, cfg.vocab, tuple(like.shape), generator=g,
                             device=dev, dtype=like.dtype)

    if kind == "prefill":
        return (params, tokens(structs[1]))
    if kind == "serve":
        cache = {k: (torch.randn(tuple(v.shape), generator=g, device=dev,
                                 dtype=v.dtype) if v.is_floating_point()
                     else torch.full(tuple(v.shape), MESH_PROMPT,
                                     dtype=v.dtype, device=dev))
                 for k, v in structs[1].items()}
        return (params, cache, tokens(structs[2]))
    batch = structs[2]["tokens"].shape
    b = {k: torch.as_tensor(v).to(dev) for k, v in TokenPipeline(
        cfg.vocab, batch[0], batch[1], seed=3).batch_at(0).items()}
    return (params, init_adamw(params), b)


def dryrun_phase(card: str, dev="cuda") -> None:
    """``launch/dryrun.py``'s cost model against the card's own step: on
    a one-rank world (NCCL on the card) and a (1, 1) ``("data",
    "model")`` mesh, Qwen1.5-0.5B at full width in bf16 (parameters from
    ``init_params``, seed 0), at the mesh phase's reduced shapes, each
    step is first traced on meta tensors (``hlo_cost.trace_step``, priced
    by ``dryrun.price``) and then run on the card.  Gates: the real
    step's flops (``FlopCounterMode``; one rank, so global = local) equal
    the prediction; the placed inputs' bytes equal the predicted
    ``argument``; the median of 5 timed steps is at least the roofline
    bound max(compute_s, memory_s); the step's peak above what was
    allocated before it is at least 0.95 x the predicted ``peak`` (the
    trace frees a buffer at its last use, eager PyTorch never sooner).
    No kernel of the port lies on this path."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, hlo_cost, steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training.tree import leaves

    t_phase = time.monotonic()
    ops.reset_launch_counts()
    cfg = get(MESH_ARCH)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"),
                               device_type=torch.device(dev).type)
        params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                             dtype=steps.COMPUTE_DTYPE, device=dev)
        for kind, spec in (("prefill", MESH_PREFILL), ("serve", MESH_DECODE),
                           ("train", MESH_TRAIN)):
            shape = steps.ShapeSpec(*spec)
            pol = ShardingPolicy(mesh, mode="train" if kind == "train"
                                 else "serve")
            step, structs, meta = steps.build_cell(cfg, shape, pol,
                                                   device=dev)
            t0 = time.monotonic()
            graph = hlo_cost.trace_step(step, structs)
            t_trace = time.monotonic() - t0
            pred = dryrun.price(graph, cfg, shape, chips=1)
            mem, roof = pred["memory"], pred["roofline"]

            args = dryrun_inputs(kind, structs, params, cfg, dev)
            placed = tuple(steps.place(a, s)
                           for a, s in zip(args, step.in_shardings))
            arg_bytes = sum(x.to_local().numel()
                            * x.to_local().element_size()
                            for x in leaves(placed))
            out = step(*placed)                            # warm-up
            del out
            with FlopCounterMode(display=False) as fc:
                out = step(*placed)
            flops = fc.get_total_flops()
            del out
            times, peak = [], 0
            for i in range(DRYRUN_TIMED):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*placed)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
                peak = max(peak, torch.cuda.max_memory_allocated() - before)
                probe = full_tensor(out[-1]["loss"] if kind == "train"
                                    else out[0])
                if not bool(torch.isfinite(probe).all()):
                    fail(f"dryrun {kind}: a non-finite output")
                del out, probe
            t_step = float(np.median(times))
            bound_s = max(roof["compute_s"], roof["memory_s"])
            print(f"  [{card}] dryrun {kind} {cfg.name} bf16 {shape.batch} "
                  f"x {shape.seq}: traced in {t_trace:.1f} s "
                  f"({len(graph.graph.nodes)} nodes); flops predicted "
                  f"{pred['flops_per_device']}, counted on the card "
                  f"{flops} (ratio {flops / pred['flops_per_device']:.6f}); "
                  f"argument bytes predicted {mem['argument']}, placed "
                  f"{arg_bytes}; bytes predicted {pred['bytes_per_device']}"
                  f"; step {t_step * 1e3:.3f} ms (median of "
                  f"{DRYRUN_TIMED}), bound {bound_s * 1e3:.3f} ms "
                  f"(compute {roof['compute_s'] * 1e3:.3f}, memory "
                  f"{roof['memory_s'] * 1e3:.3f}; step / bound "
                  f"{t_step / bound_s:.2f}); peak above the inputs "
                  f"{peak} B, predicted {mem['peak']} B (ratio "
                  f"{peak / mem['peak']:.4f}, gate {DRYRUN_PEAK_SHARE}); "
                  f"per-device total predicted "
                  f"{mem['per_device_total'] / 2**30:.3f} GiB", flush=True)
            if flops != pred["flops_per_device"]:
                fail(f"dryrun {kind}: {flops} flops on the card, "
                     f"{pred['flops_per_device']} predicted")
            if arg_bytes != mem["argument"]:
                fail(f"dryrun {kind}: {arg_bytes} argument bytes placed, "
                     f"{mem['argument']} predicted")
            if not t_step >= bound_s:
                fail(f"dryrun {kind}: a step of {t_step * 1e3:.3f} ms is "
                     f"faster than its bound {bound_s * 1e3:.3f} ms")
            if not peak >= DRYRUN_PEAK_SHARE * mem["peak"]:
                fail(f"dryrun {kind}: peak {peak} B below "
                     f"{DRYRUN_PEAK_SHARE} x the predicted {mem['peak']} B")
            del placed, args, step, structs, graph
            gc.collect()
            torch.cuda.empty_cache()
        del params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"dryrun: a serving kernel launched on the sharded steps: "
             f"{counts}")
    print(f"  [{card}] dryrun: process group destroyed; no CUDA kernel of "
          f"the port launched", flush=True)

    # the dry run's multi-rank path: one production cell on a fake group
    # of 256 ranks, priced, nothing run
    rec = dryrun.run_cell(MESH_ARCH, "decode_32k", False,
                          str(ROOT / "build" / "dryrun"), verbose=False)
    if not rec["ok"]:
        fail(f"dryrun {MESH_ARCH} decode_32k on (16, 16): {rec['error']}")
    mem, roof = rec["memory"], rec["roofline"]
    print(f"  [{card}] dryrun {MESH_ARCH} decode_32k on the (16, 16) mesh "
          f"({rec['chips']} fake ranks, torch {torch.__version__}): "
          f"{mem['per_device_total'] / 2**30:.3f} GiB a rank (fits 80 GB "
          f"{mem['fits_80GB']}), flops {rec['flops_per_device']}, bytes "
          f"{rec['bytes_per_device']}, collective bytes "
          f"{rec['collectives']['total']}; compute "
          f"{roof['compute_s'] * 1e3:.3f} ms, memory "
          f"{roof['memory_s'] * 1e3:.3f} ms, collective "
          f"{roof['collective_s'] * 1e3:.3f} ms -> {roof['dominant']}-bound "
          f"(a prediction); traced in {rec['trace_s']} s; phase "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)


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

    phase("moe")
    counts_moe_a, counts_moe_b1, counts_moe_b2 = moe_phase(card)

    phase("families")
    families_phase(card)

    phase("disagg")
    counts_da, counts_db1, counts_db2, counts_dc = disagg_phase(card)

    phase("sim")
    est, sim_row, params, counts_sim = sim_phase(card)

    phase("frontend")
    counts_fe = frontend_phase(card, est, sim_row, params)
    del params

    phase("train")
    train_phase(card)

    phase("mesh")
    mesh_phase(card)

    phase("dryrun")
    dryrun_phase(card)

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
    # moe passes, the disagg passes, the sim phase's profile, the frontend
    # passes), each
    # read right after its run with the counts set to 0 just before it
    runs = {"serve": counts, "serve, lanes off": counts_off,
            "tiered (a)": counts_a, "tiered (b)": counts_b,
            "spec, same draft": counts_same,
            "spec, other draft": counts_other, "per-request": counts_pr,
            "glm": counts_glm, "moe (a)": counts_moe_a,
            "moe (b) run 1": counts_moe_b1, "moe (b) run 2": counts_moe_b2,
            "disagg (a)": counts_da,
            "disagg (b) run 1": counts_db1, "disagg (b) run 2": counts_db2,
            "disagg (c)": counts_dc, "sim profile": counts_sim,
            **counts_fe}
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
