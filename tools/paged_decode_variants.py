"""Time variants of the paged decode / verify kernel on the card.

    python3 tools/paged_decode_variants.py                 # the default set
    python3 tools/paged_decode_variants.py c2_b4k c4_b4k   # some of them

Each variant is ``src/repro_torch/csrc/paged_attention.cu`` with some of
its ``constexpr int`` constants replaced (CLUSTER, WARPS, STAGES,
STAGE_BYTES), compiled by nvcc for sm_90a into its own library under
``build/variants/`` (all variants in parallel) and called through the same
C entry points as the port.  Every variant is held against the plain
version (fp32 2e-5, bf16 2e-2, rows of length > 0) and timed with
``chip_smoke.time_ms`` (cold L2) at these shapes:

  qwen / qwen_bf16  the kernels phase's decode: q (16, 16, 64), 48-page
                    table, lengths 1..768
  gqa               Qwen2-7B widths: H 28, Hkv 4, hd 128, lengths 1..768
  serve             12 rows of 64..530 positions and 4 length-0 rows
  zero_len          16 rows of length 0 (the launch's fixed cost)
  one_page          16 rows of 16 positions
  long1             one row of 768 positions (one row's chain)
  verify            the kernels phase's 16 requests x 3 verify rows
  floor             a 4-byte ``zero_`` under the same protocol

Two rounds, one line per variant and round.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import math
import re
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
    "c2_b4k": {},                          # the source as it stands
    "c2_b4k_s3": {"STAGES": 3},
    "c4_b4k": {"CLUSTER": 4},
    "c2_b8k": {"STAGE_BYTES": 8192},
    "c4_b8k": {"CLUSTER": 4, "STAGE_BYTES": 8192},
}


def variant_text(src: str, subs: dict, name: str) -> str:
    """``src`` with each ``constexpr int KEY = ...;`` set to ``subs[KEY]``."""
    for key, val in subs.items():
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
        if n != 1:
            raise SystemExit(f"{name}: no constant {key}")
    return src


def compile_sources(texts: dict) -> dict:
    """Each source text of ``texts`` (name -> CUDA source) compiled by nvcc
    for sm_90a into its own library under ``build/variants/``, all in
    parallel; prints each one's registers and spills; returns name ->
    loaded library with the port's C signatures set."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             str(cu), "-o", str(out / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        spills = [s for s in re.findall(r"(\d+) bytes spill stores", log)
                  if s != "0"]
        regs = max(map(int, re.findall(r"Used (\d+) registers", log)))
        print(f"{name}: built, max {regs} registers, spill stores "
              f"{spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def compile_variants(names) -> dict:
    from repro_torch.kernels import build
    src = (build.CSRC / "paged_attention.cu").read_text()
    return compile_sources({name: variant_text(src, VARIANTS[name], name)
                            for name in names})


def call(lib, q, kp, vp, bt, ln, seg=None):
    from repro_torch.kernels.paged_attention import DTYPES
    out = torch.empty_like(q)
    b, h, hd = q.shape
    args = [DTYPES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            bt.data_ptr(), ln.data_ptr()]
    tail = [out.data_ptr(), b, h, kp.shape[2], hd, kp.shape[1],
            bt.shape[1], 1.0 / math.sqrt(hd), torch.cuda.current_device(),
            torch.cuda.current_stream().cuda_stream]
    if seg is None:
        err = lib.proserve_paged_decode(*args, *tail)
    else:
        err = lib.proserve_packed_verify(*args, seg.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import ref

    names = sys.argv[1:] or list(VARIANTS)
    t0 = time.monotonic()
    libs = compile_variants(names)
    print(f"compiled in {time.monotonic() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bench = [1, 2, 15, 16, 17, 64, 100, 200, 333, 400, 512, 513, 600, 700,
             767, 768]
    cases = {
        "qwen": cs.decode_case(rng, 16, 16, 16, 64, 16, 48, bench, dev),
        "gqa": cs.decode_case(rng, 16, 28, 4, 128, 16, 48,
                              [1, 5, 16, 17, 90, 128, 257, 300, 411, 500,
                               512, 600, 640, 700, 767, 768], dev),
        "serve": cs.decode_case(rng, 16, 16, 16, 64, 16, 48,
                                [80, 530, 150, 96, 300, 210, 64, 512, 420,
                                 130, 260, 333, 0, 0, 0, 0], dev),
        "zero_len": cs.decode_case(rng, 16, 16, 16, 64, 16, 48, [0] * 16,
                                   dev),
        "one_page": cs.decode_case(rng, 16, 16, 16, 64, 16, 48, [16] * 16,
                                   dev),
        "long1": cs.decode_case(rng, 1, 16, 16, 64, 16, 48, [768], dev),
    }
    cases["qwen_bf16"] = [a.bfloat16() if a.is_floating_point() else a
                          for a in cases["qwen"]]
    v_args, seg = cs.verify_case(rng, 16, 2, 16, 16, 64, 16, 160, 48,
                                 bench[:-2] + [764, 765], dev)
    seg_dev = seg.to(torch.int32).to(dev)
    want = {k: ref.paged_decode_attention_ref(*a) for k, a in cases.items()}
    want_v = ref.packed_verify_attention_ref(*v_args, seg)
    tiny = torch.zeros(1, device=dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; floor (4-byte zero_) "
          f"{cs.time_ms(lambda: tiny.zero_()):.4f} ms", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            row = []
            for key, args in cases.items():
                got = call(lib, *args)
                torch.cuda.synchronize()
                live = args[4] > 0
                tol = 2e-2 if args[0].dtype == torch.bfloat16 else 2e-5
                err = float((got[live].float()
                             - want[key][live].float()).abs().max()) \
                    if bool(live.any()) else 0.0
                if err > tol:
                    raise SystemExit(f"{name} {key}: max abs err {err}")
                row.append(f"{key} {cs.time_ms(lambda: call(lib, *args)):.4f}")
            got = call(lib, *v_args, seg_dev)
            torch.cuda.synchronize()
            if float((got - want_v).abs().max()) > 2e-5:
                raise SystemExit(f"{name} verify disagrees")
            row.append("verify %.4f" % cs.time_ms(
                lambda: call(lib, *v_args, seg_dev)))
            print(f"round {rnd} {name}: " + " | ".join(row), flush=True)


if __name__ == "__main__":
    main()
