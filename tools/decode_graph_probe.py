"""The fused decode step eager and as CUDA graph replays, on the card.

    python3 tools/decode_graph_probe.py [--arch qwen2_7b] [--out FILE]

At the model's full published width and depth (fp32, TF32 off, random
weights), over a 2,048-block pool of 16-token blocks, for batch buckets 1,
4 and 8 (rows of 100-2,000 positions, 4 rows real in bucket 8's half):

* the eager ``decode_step`` a step, ms (host wall, the token fetch
  included, as the engine runs it), and the kernels and copies one eager
  step launches (``torch.profiler``, CUDA activity);
* the first graph step (``DecodeGraphs.warm`` + ``capture``) and its
  capture alone, ms; a replay a step, ms, and the kernels it runs;
* the paged decode kernel alone at table width 12 and 192 over the same
  rows (lengths <= 12 pages), mean us a launch (CUDA events) and whether
  the two outputs are bitwise equal.

Prints one JSON line (and writes it to ``--out``).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import model_exec  # noqa: E402

BS, BLOCKS, WIDTH = 16, 2048, 192


def rows(rng, cfg, b: int, n_real: int):
    lens = rng.integers(100, 2000, n_real)
    free = list(rng.permutation(np.arange(1, BLOCKS)))
    table = np.zeros((b, WIDTH), np.int32)
    for i, n in enumerate(lens):
        k = -(-(int(n) + 1) // BS)
        table[i, :k] = free[:k]
        del free[:k]
    tokens = np.zeros(b, np.int32)
    tokens[:n_real] = rng.integers(1, cfg.vocab, n_real)
    full = np.zeros(b, np.int32)
    full[:n_real] = lens
    return tokens, table, full


def wall_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e3 * (time.perf_counter() - t0) / n


def device_ops(fn) -> dict:
    """Kernels and memcpys / memsets one call runs, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"kernels": 0, "copies": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kinds["copies" if "memcpy" in name or "memset" in name
              else "kernels"] += 1
    return kinds


def probe_bucket(cfg, params, pool, rng, b: int, n_real: int) -> dict:
    tokens, table, lens = rows(rng, cfg, b, n_real)
    dev = pool.device
    t_d, tab_d, len_d = (torch.from_numpy(a).to(dev)
                         for a in (tokens, table, lens))

    def eager():
        toks, _ = model_exec.decode_step(cfg, params, pool, t_d, tab_d,
                                         len_d)
        return toks.cpu()

    for _ in range(2):
        want = eager()
    out = {"b": b, "rows": n_real, "eager_ms": wall_ms(eager, 10),
           "eager_ops": device_ops(eager)}
    graphs = model_exec.DecodeGraphs(cfg, params, WIDTH, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphs.upload(tokens, table, lens)
    first = graphs.warm(b, pool)
    t1 = time.perf_counter()
    graphs.capture(b, pool)
    t2 = time.perf_counter()
    first = first.cpu()
    out.update(first_step_ms=1e3 * (time.perf_counter() - t0),
               capture_ms=1e3 * (t2 - t1))

    def replay():
        graphs.upload(tokens, table, lens)
        return graphs.replay(b).cpu()

    got = replay()
    out.update(replay_ms=wall_ms(replay, 20), replay_ops=device_ops(replay),
               tokens_equal=bool(torch.equal(got, want)
                                 and torch.equal(first, want)))
    return out


def kernel_width(cfg, pool, rng) -> dict:
    """The decode kernel over 8 rows of <= 12 pages at widths 12 and 192."""
    b = 8
    lens = rng.integers(120, 12 * BS, b).astype(np.int32)
    blocks = rng.permutation(np.arange(1, BLOCKS))[:b * 12].reshape(b, 12)
    narrow = blocks.astype(np.int32)
    wide = np.zeros((b, WIDTH), np.int32)
    wide[:, :12] = narrow
    dev = pool.device
    q = torch.randn((b, cfg.n_heads, cfg.hd), device=dev)
    kp, vp = pool[0, 0], pool[0, 1]
    ln = torch.from_numpy(lens).to(dev)
    res = {}
    outs = {}
    for name, tab in (("w12", narrow), ("w192", wide)):
        t = torch.from_numpy(tab).to(dev)
        for _ in range(10):
            outs[name] = ops.paged_decode_attention(q, kp, vp, t, ln)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(200):
            ops.paged_decode_attention(q, kp, vp, t, ln)
        end.record()
        end.synchronize()
        res[f"{name}_us"] = 1e3 * start.elapsed_time(end) / 200
    res["bitwise_equal"] = bool(torch.equal(outs["w12"], outs["w192"]))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get(args.arch)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    pool = torch.randn((cfg.n_layers, 2, BLOCKS, BS, cfg.n_kv_heads,
                        cfg.hd), device=dev)
    rng = np.random.default_rng(0)
    res = {"arch": args.arch, "device": torch.cuda.get_device_name(dev),
           "torch": torch.__version__,
           "buckets": [probe_bucket(cfg, params, pool, rng, b, n)
                       for b, n in ((1, 1), (4, 4), (8, 4), (8, 8))],
           "kernel_width": kernel_width(cfg, pool, rng)}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
