"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/kernels/libproserve_kernels.so``
under the repository root, and loaded with ``ctypes``.  The sources are
compiled in parallel (one ``nvcc`` per file) and linked once.  A hash of
the sources and flags is kept beside the library; the library is rebuilt
when it changes.  Nothing here runs at import time: the first kernel
launch calls ``library()``, under a lock, so two threads that launch
first at the same time (the engine and the transfer worker) build once.
A failed build raises; there is no fallback.

``count_launch`` / ``reset_launches`` keep each wrapper's launch counter
under one lock, so launches from both threads are counted exactly.  A
launch issued while its thread captures a CUDA graph (``recording()``)
runs nothing: it is noted in the recording instead, and
``add_launches`` counts the recording once per replay.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libproserve_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as
# c_void_p, so 64-bit addresses are not cut to 32-bit ints)
SIGNATURES = {
    # dtype, q, k, v, tables, lengths, out, B, H, Hkv, hd, page, maxp,
    # scale, device, stream
    "proserve_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _F, _I, _P],
    # dtype, q, k, v, tables, lengths, row_seg, out, R, H, Hkv, hd, page,
    # maxp, scale, device, stream
    "proserve_packed_verify": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, _I, _P],
    # dtype, hd, G, device, out (7 ints): the decode kernel's launch shape
    "proserve_paged_decode_info": [_I, _I, _I, _I, _P],
    # dtype, q, k, v, ctx_lens, out, S, Sq, H, Hkv, hd, Smax, scale,
    # device, stream
    "proserve_packed_prefill": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _F, _I, _P],
    # dtype, q, k, v, cache_lens, out, B, Sq, H, Hkv, hd, Smax, scale,
    # device, stream
    "proserve_chunked_prefill": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _F, _I, _P],
    # dtype, x, vals, scales, R, E, device, stream
    "proserve_kv_quantize": [_I, _P, _P, _P, _I, _LL, _I, _P],
    # vals, scales, out, R, E, device, stream
    "proserve_kv_dequantize": [_P, _P, _P, _I, _LL, _I, _P],
    # pool, idx, out, n, planes, N, row_bytes, device, stream
    "proserve_block_gather": [_P, _P, _P, _I, _I, _LL, _LL, _I, _P],
}
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# per thread: the Counter of the capture under way (``recording()``)
_CAPTURE = threading.local()


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


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
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


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel launched), or to this
    thread's recording while it captures a graph."""
    rec = getattr(_CAPTURE, "rec", None)
    if rec is not None:
        rec[wrapper] += 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextmanager
def recording():
    """The launches this thread issues inside the block, as a Counter of
    wrapper -> launches, kept out of the wrappers' counters (a graph's
    capture records its kernels; its replays run them)."""
    _CAPTURE.rec = rec = Counter()
    try:
        yield rec
    finally:
        _CAPTURE.rec = None


def add_launches(rec: Counter) -> None:
    """Count a recording's launches once (one replay of its graph)."""
    with _COUNT_LOCK:
        for wrapper, n in rec.items():
            wrapper.launches += n


def reset_launches(wrappers) -> None:
    with _COUNT_LOCK:
        for w in wrappers:
            w.launches = 0
