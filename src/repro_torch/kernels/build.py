"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/kernels/libproserve_kernels.so``
under the repository root, and loaded with ``ctypes``.  The sources are
compiled in parallel (one ``nvcc`` per file) and linked once.  A hash of
the sources and flags is kept beside the library; the library is rebuilt
when it changes.  Nothing here runs at import time: the first kernel
launch calls ``library()``.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libproserve_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p, so 64-bit addresses are not cut to 32-bit ints)
SIGNATURES = {
    # dtype, q, k, v, tables, lengths, out, B, H, Hkv, hd, page, maxp,
    # scale, device, stream
    "proserve_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _F, _I, _P],
    # dtype, q, k, v, ctx_lens, out, S, Sq, H, Hkv, hd, Smax, scale,
    # device, stream
    "proserve_packed_prefill": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _F, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def build(verbose: bool = False) -> str:
    """Compile every source and link the library; returns the compilers'
    messages (with ``verbose``, ptxas's register / shared-memory / spill
    report for each kernel).  Raises ``RuntimeError`` on any failure."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = source_hash()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [exe, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs, failed = [], []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [exe, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_lib, BUILD_DIR / LIB_NAME)
    (BUILD_DIR / (LIB_NAME + ".sha256")).write_text(digest)
    return "\n".join(logs)


def is_current() -> bool:
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    return ((BUILD_DIR / LIB_NAME).is_file() and stamp.is_file()
            and stamp.read_text() == source_hash())


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    if not is_current():
        build()
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
