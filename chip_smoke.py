"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py            # needs one CUDA card; no arguments
    python3 chip_smoke.py --profile  # also: device time by kernel for the
                                     # serve traffic (build/profile)

Phases (any failure exits non-zero; nothing is caught and continued):
  1. env     — the card's name and power limit (nvidia-smi), torch / CUDA.
  2. build   — every ``src/repro_torch/csrc/*.cu`` compiled with nvcc for
               sm_90a (``-Xptxas -v``): registers, shared memory and spills
               of each kernel.
  3. kernels — each CUDA kernel held against its plain PyTorch version at
               the serve phase's shapes (Qwen1.5-0.5B: H = Hkv = 16,
               hd 64, page 16) and at Qwen2-7B's GQA widths (H 28, Hkv 4,
               hd 128), fp32 atol = rtol = 2e-5; then timed with CUDA
               events beside the plain version and, for packed prefill,
               one ``F.scaled_dot_product_attention`` call (a yardstick the
               port never calls).
  4. serve   — the port's entry point ``repro_torch.launch.serve`` at the
               full width of Qwen1.5-0.5B (24 layers, fp32, random weights
               from seed 0): two waves of multi-priority requests with
               prefix-cache hits and preemption.  Every stream must equal
               greedy decoding by the port's own full-sequence forward;
               each kernel's launch count must equal n_layers x the
               engine's launches of its step; host syncs must equal model
               launches.

fp32 matmuls run in full fp32: TF32 is switched off for cuBLAS and cuDNN.
The last two lines are the ``{"kernels": ...}`` JSON and the
``{"ok": true, ...}`` JSON.
"""
from __future__ import annotations

import json
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
TOL = dict(atol=2e-5, rtol=2e-5)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


L2_FLUSH_BYTES = 128 << 20     # > the H100's 50 MB L2


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
    tables and lengths read once, the output written once; 4 flops per
    (query head, live position, dim) for QK^T and PV."""
    b, h, hd = q.shape
    hkv = kp.shape[2]
    live = int(lens.sum())
    nbytes = (2 * live * hkv * hd + 2 * b * h * hd) * 4 \
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
    keys at 4 flops per (head, key, dim)."""
    s, sq, h, hd = q.shape
    smax, hkv = kc.shape[1], kc.shape[2]
    keys = 0
    kv_rows = 0
    for c in ctx.tolist():
        r = np.arange(sq)
        keys += int(np.minimum(smax, c + r + 1).sum())
        kv_rows += min(smax, c + sq)
    nbytes = (2 * kv_rows * hkv * hd + 2 * s * sq * h * hd + s) * 4
    flops = 4 * keys * h * hd
    return bound(nbytes, flops)


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rows=None) -> float:
    torch.cuda.synchronize()
    if rows is not None:
        got, want = rows(got), rows(want)
    err = float((got - want).abs().max())
    try:
        torch.testing.assert_close(got, want, **TOL)
    except AssertionError as e:
        fail(f"{name} disagrees with its plain version: {e}")
    print(f"  {name}: max_abs_err {err:.3e} (fp32 atol=rtol=2e-5) ok",
          flush=True)
    return err


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
    for label, c in cases.items():
        print(f"  -- {label}", flush=True)
        d_args = decode_case(rng, *c["decode"], dev)
        p_args = prefill_case(rng, *c["prefill"], dev)
        q, kc, vc, ctx = p_args
        rows = real_rows(ctx, q.shape[1], kc.shape[1])
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
        for name, r in results[label].items():
            print(f"  {name}: kernel {r['ms']:.4f} ms (warm L2 "
                  f"{r['warm_l2_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                  f"[{r['shape']}]", flush=True)
    return results


# --------------------------------------------------------------------------
# serve phase
# --------------------------------------------------------------------------

def serve_phase(card: str):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import forward

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.main(["--arch", "qwen1_5_0_5b", "--device", "cuda",
                      "--seed", "0"])
    counts = ops.launch_counts()
    cfg, params, eng = res.cfg, res.params, res.engine
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()

    summary = res.summary()
    print(f"  [{card}] served {summary['requests']} requests in "
          f"{summary['wall_s']:.3f} s: {summary['tokens_per_s']:.1f} "
          f"tokens/s (prefill + output), "
          f"{summary['output_tokens_per_s']:.1f} output tokens/s",
          flush=True)
    for p in (1, 2, 3):
        print(f"  [{card}] priority {p}: TTFT p50 "
              f"{summary[f'ttft_p50_s_prio{p}']:.4f} s, TPOT p50 "
              f"{summary[f'tpot_p50_s_prio{p}']:.4f} s", flush=True)
    print(f"  [{card}] TDG_Ratio {summary['tdg_ratio']:.4f}, evictions "
          f"{st.evictions}, reload blocks {st.reload_blocks}, cache-hit "
          f"tokens {st.cache_hit_tokens}, cow forks {st.cow_forks}, "
          f"iterations {st.iterations}, decode launches "
          f"{st.decode_launches}, packed prefill calls "
          f"{st.packed_prefill_calls}, host syncs {st.host_syncs}, "
          f"max_memory_allocated {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launch counts {counts}", flush=True)

    if st.evictions < 1:
        fail("the serve phase had no eviction")
    if st.cache_hit_tokens < 1:
        fail("the serve phase had no prefix-cache hit")
    if counts["paged_decode_attention"] != cfg.n_layers * st.decode_launches:
        fail(f"paged decode launches {counts['paged_decode_attention']} != "
             f"{cfg.n_layers} x {st.decode_launches}")
    if counts["packed_prefill_attention"] != \
            cfg.n_layers * st.packed_prefill_calls:
        fail(f"packed prefill launches {counts['packed_prefill_attention']}"
             f" != {cfg.n_layers} x {st.packed_prefill_calls}")
    if st.host_syncs != st.decode_launches + st.packed_prefill_calls:
        fail(f"host syncs {st.host_syncs} != decode launches + packed "
             "prefill calls")

    # every stream against greedy decoding by the port's own forward
    t0 = time.monotonic()
    for r, prompt in res.requests:
        got = eng.outputs[r.rid]
        cur = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
        for pos in range(r.output_len):
            logits = forward(cfg, params, cur, last_only=True)[0, -1]
            want = int(logits.argmax())
            if got[pos] != want:
                top2 = torch.topk(logits, 2).values
                fail(f"rid {r.rid} (priority {r.priority}) diverges at "
                     f"output position {pos}: engine {got[pos]}, greedy "
                     f"forward {want}, top-2 logit margin "
                     f"{float(top2[0] - top2[1]):.3e}")
            cur = torch.cat([cur, cur.new_tensor([[want]])], dim=1)
    print(f"  all {len(res.requests)} streams equal greedy forward token "
          f"for token ({time.monotonic() - t0:.1f} s)", flush=True)
    return counts, summary, peak


def profile_phase(out_dir: Path) -> None:
    """Serve the same traffic twice more, the second time under
    torch.profiler: device time by kernel, and the device's busy share of
    the first (unprofiled) run's wall time; also written to
    ``out_dir/kernels.json``.  Runs only with ``--profile``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    cfg = get("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    plain_wall = serve.serve(cfg, params, serve.FULL, seed=0).wall_s
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = serve.serve(cfg, params, serve.FULL, seed=0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []          # device kernels only: host ops would count twice
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    st = res.engine.stats
    print(f"  device busy {busy:.3f} s = {100 * busy / plain_wall:.1f} % "
          f"of the unprofiled serve wall {plain_wall:.3f} s (idle "
          f"{100 * (1 - busy / plain_wall):.1f} %); profiled wall "
          f"{wall:.3f} s; iterations {st.iterations}, decode launches "
          f"{st.decode_launches}, packed prefill calls "
          f"{st.packed_prefill_calls}", flush=True)
    for dev_us, key, count in rows[:25]:
        print(f"  {dev_us / 1e3:10.3f} ms {100 * dev_us / 1e6 / busy:5.1f} "
              f"% x{count:6d}  {key[:90]}", flush=True)
    (out_dir / "kernels.json").write_text(json.dumps(
        {"wall_s": plain_wall, "profiled_wall_s": wall,
         "device_busy_s": busy,
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
    print(f"  built {build.BUILD_DIR / build.LIB_NAME} in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    build.library()

    phase("kernels")
    kres = kernels_phase(dev)

    phase("serve")
    counts, summary, peak = serve_phase(card)

    if "--profile" in sys.argv[1:]:
        phase("profile")
        profile_phase(ROOT / "build" / "profile")

    main_path = kres["qwen1.5-0.5b"]
    meta = {
        "paged_decode_attention": dict(
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:88"),
        "packed_prefill_attention": dict(
            source="src/repro_torch/csrc/packed_prefill.cu",
            replaces="src/repro/kernels/chunked_prefill.py:148"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", **meta[name],
         "launches": counts[name],
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
