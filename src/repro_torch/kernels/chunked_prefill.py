"""Packed multi-request and per-request chunked prefill attention: the
wrappers of the CUDA kernel ``csrc/packed_prefill.cu`` (port of
``packed_prefill_attention`` and ``chunked_prefill_attention`` in
``repro.kernels.chunked_prefill``).

Both launch one kernel body through its two C entry points, which differ
only in where a query row sits: at ``ctx_lens[s] + r`` (packed) or at
``cache_lens[b] - Sq + r`` (chunked), so per segment the packed kernel is
bitwise the chunked one at ``cache_lens = ctx_lens + Sq``.  The kernel
runs on the tensor cores: fp32 as three TF32 products per product
(3xTF32, fp32-level error, not TF32's), bf16 as bf16 products with fp32
accumulation.  Each wrapper
launches the kernel on CUDA tensors and raises on anything it does not
take; ``repro_torch.kernels.ops`` dispatches CPU tensors to the plain
versions in ``ref.py``.  ``<wrapper>.launches`` counts each one's
launches.
"""
from __future__ import annotations

import math

import torch

from . import build
from .paged_attention import DTYPES, HEAD_DIMS, check_tensor, device_index


def _launch(wrapper, entry: str, q, k_cache, v_cache, lens, lens_name):
    """Check the tensors, launch C entry ``entry``, count the launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    check_tensor("q", q, dev, q.dtype, 4)
    check_tensor("k_cache", k_cache, dev, q.dtype, 4)
    check_tensor("v_cache", v_cache, dev, q.dtype, 4)
    check_tensor(lens_name, lens, dev, torch.int32, 1)
    s, sq, h, hd = q.shape
    _, smax, hkv, hd_k = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != s
            or hd_k != hd or lens.shape[0] != s):
        raise ValueError(f"shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"{lens_name} {tuple(lens.shape)} do not match")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q, k_cache and v_cache must start on 16 bytes "
                         "(the kernel copies 16-byte chunks)")
    out = torch.empty_like(q)
    err = getattr(build.library(), entry)(
        DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lens.data_ptr(), out.data_ptr(), s, sq, h, hkv,
        hd, smax, 1.0 / math.sqrt(hd), device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, wrapper.__name__)
    build.count_launch(wrapper)
    return out


def packed_prefill_attention(q, k_cache, v_cache, ctx_lens):
    """q: (S, Sq, H, hd) chunk queries, right-padded to a common Sq;
    k/v_cache: (S, Smax, Hkv, hd) staged caches with each chunk's K/V
    already written at [ctx, ctx + chunk); ctx_lens: (S,) int32 tokens
    cached BEFORE each chunk.  Query row r of segment s sits at
    ``ctx_lens[s] + r``.  Returns (S, Sq, H, hd) in q's dtype."""
    return _launch(packed_prefill_attention, "proserve_packed_prefill", q,
                   k_cache, v_cache, ctx_lens, "ctx_lens")


def chunked_prefill_attention(q, k_cache, v_cache, cache_lens):
    """q: (B, Sq, H, hd); k/v_cache: (B, Smax, Hkv, hd) with the chunk's
    K/V already written at [cache_lens - Sq, cache_lens); cache_lens: (B,)
    int32 valid lengths INCLUDING the chunk.  Query row j sits at
    ``cache_lens[b] - Sq + j``; a row at a negative position sees no key
    and is 0, as in the TPU kernel.  Returns (B, Sq, H, hd) in q's
    dtype."""
    return _launch(chunked_prefill_attention, "proserve_chunked_prefill", q,
                   k_cache, v_cache, cache_lens, "cache_lens")


packed_prefill_attention.launches = 0
chunked_prefill_attention.launches = 0
