"""Time variants of the int8 quantize kernel on the card.

    python3 tools/kv_quant_variants.py                      # the default set
    python3 tools/kv_quant_variants.py nv4_c8 nv8_c8        # some of them
    python3 tools/kv_quant_variants.py --source old=OLD.cu  # and another
                                                            # kv_quant.cu

Each variant is ``src/repro_torch/csrc/kv_quant.cu`` with some of its
``constexpr int`` constants replaced (NV: 16-byte vectors a thread holds;
MAX_CLUSTER: blocks a row may take; THREADS: threads per block; or a
piece of text, left out or replaced), compiled by nvcc for sm_90a into its own
library under ``build/variants/`` (all in parallel) and called through the
port's C entry ``proserve_kv_quantize``.  ``--source NAME=PATH`` (any
number of times) adds another source of that entry, for instance an
earlier commit's, as the variant NAME.  Every variant is held bitwise against the plain version and
timed with ``chip_smoke.time_ms``, cold and warm L2, at these shapes:

  qwen        one demoted group of 8 Qwen1.5-0.5B blocks (8, 24, 2, 16,
              16, 64) fp32: 384 rows of 16384 values (chip_smoke's row)
  qwen_bf16   the same in bf16
  glm         8 ChatGLM3-6B blocks (8, 28, 2, 16, 2, 128): 448 rows of 4096
  one_block   one Qwen1.5-0.5B block (1, 24, 2, 16, 16, 64)
  floor       a 4-byte ``zero_`` under the same protocol

Each entry reads "cold / read-flushed [warm]" ms: cold is chip_smoke's
protocol (L2 flushed by writing 128 MiB, so the call's misses also write
back the flush's dirty lines), read-flushed flushes it by reading 128
MiB (clean lines), warm leaves the input in L2.  Two rounds, one line per
variant and round.  Needs one CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "nv4_c8": {},                          # the source as it stands
    "nv2_c8": {"NV": 2},
    "nv8_c8": {"NV": 8},
    "nv4_c2": {"MAX_CLUSTER": 2},
    "nv4_c1": {"MAX_CLUSTER": 1},          # one block a row, slices looped
}


def time_read_flushed(fn, iters: int = 30, warmup: int = 3) -> float:
    """``chip_smoke.time_ms`` with L2 flushed by READING 128 MiB instead
    of writing it: the L2 then holds clean lines, so the call's misses
    evict without write-backs."""
    import chip_smoke as cs
    flush = torch.zeros(cs.L2_FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        torch.sum(flush, dim=0, out=sink)
        torch.cuda._sleep(cs.SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def call(lib, x):
    from repro_torch.kernels.paged_attention import DTYPES
    n, lyr = x.shape[:2]
    vals = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((n, lyr, 2), dtype=torch.float32, device=x.device)
    err = lib.proserve_kv_quantize(
        DTYPES[x.dtype], x.data_ptr(), vals.data_ptr(), scales.data_ptr(),
        n * lyr * 2, x[0, 0, 0].numel(), torch.cuda.current_device(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return vals, scales


def blocks(rng, shape, dev):
    x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev)
    x[0, 0, 1] = 0.0                                       # a zero plane
    e = x[0, 0, 0].numel()
    half = torch.arange(e, dtype=torch.float32, device=dev) % 254 - 126.5
    half[0] = 127.0
    x[-1, -1, 0] = half.reshape(x.shape[3:])               # half steps
    return x


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from tools.paged_decode_variants import compile_sources, variant_text

    args = sys.argv[1:]
    rows = "--rows" in args
    if rows:
        args.remove("--rows")
    texts = {}
    while "--source" in args:
        i = args.index("--source")
        name, path = args[i + 1].split("=", 1)
        texts[name] = Path(path).read_text()
        del args[i:i + 2]
    src = (build.CSRC / "kv_quant.cu").read_text()
    for name in args or list(VARIANTS):
        subs = VARIANTS[name]
        text = variant_text(src, {k: v for k, v in subs.items()
                                  if k.isidentifier()}, name)
        for old, new in subs.items():      # text replaced as it stands
            if not old.isidentifier():
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: no single {old!r}")
                text = text.replace(old, new)
        texts[name] = text
    t0 = time.monotonic()
    libs = compile_sources(texts)
    print(f"compiled in {time.monotonic() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = {"qwen": blocks(rng, (8, 24, 2, 16, 16, 64), dev),
             "glm": blocks(rng, (8, 28, 2, 16, 2, 128), dev),
             "one_block": blocks(rng, (1, 24, 2, 16, 16, 64), dev)}
    cases["qwen_bf16"] = cases["qwen"].bfloat16()
    if rows:                    # Qwen1.5-0.5B groups of 1..32 blocks
        cases = {f"qwen_n{n}": blocks(rng, (n, 24, 2, 16, 16, 64), dev)
                 for n in (1, 2, 3, 4, 6, 8, 16, 32)}
        cases["qwen_bf16_n1"] = cases["qwen_n1"].bfloat16()
        cases["qwen_bf16_n4"] = cases["qwen_n4"].bfloat16()
        cases["qwen_bf16_n8"] = cases["qwen_n8"].bfloat16()
    want = {k: ref.kv_block_quantize_ref(x) for k, x in cases.items()}
    tiny = torch.zeros(1, device=dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; floor (4-byte zero_) "
          f"{cs.time_ms(lambda: tiny.zero_()):.4f} ms, with the L2 flushed "
          f"by a read {time_read_flushed(lambda: tiny.zero_()):.4f} ms",
          flush=True)
    for name, x in cases.items():
        r, e = x.shape[0] * x.shape[1] * 2, x[0, 0, 0].numel()
        b = cs.bound(r * e * (x.element_size() + 1) + 4 * r, 0)
        print(f"  {name}: {tuple(x.shape)} {x.dtype}, bound {b[0]:.4f} ms "
              f"({b[1]})", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            row = []
            for key, x in cases.items():
                got = call(lib, x)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want[key])):
                    raise SystemExit(f"{name} {key}: not bitwise the plain "
                                     "version")
                cold = cs.time_ms(lambda: call(lib, x))
                clean = time_read_flushed(lambda: call(lib, x))
                warm = cs.time_ms(lambda: call(lib, x), cold_l2=False)
                row.append(f"{key} {cold:.4f} / {clean:.4f} [{warm:.4f}]")
            print(f"round {rnd} {name}: " + " | ".join(row), flush=True)


if __name__ == "__main__":
    main()
