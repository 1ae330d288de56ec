"""Packed multi-request prefill attention: the wrapper of the CUDA kernel
``csrc/packed_prefill.cu`` (port of ``packed_prefill_attention`` in
``repro.kernels.chunked_prefill``).

``packed_prefill_attention`` launches the kernel on CUDA tensors and
raises on anything it does not take; ``repro_torch.kernels.ops``
dispatches CPU tensors to the plain version in ``ref.py``.
``packed_prefill_attention.launches`` counts the kernel's launches.  The
per-request ``chunked_prefill_attention`` kernel is not ported yet.
"""
from __future__ import annotations

import math

import torch

from . import build
from .paged_attention import DTYPES, check_tensor, device_index

HEAD_DIMS = (16, 32, 64, 128)   # instantiated in packed_prefill.cu


def packed_prefill_attention(q, k_cache, v_cache, ctx_lens):
    """q: (S, Sq, H, hd) chunk queries, right-padded to a common Sq;
    k/v_cache: (S, Smax, Hkv, hd) staged caches with each chunk's K/V
    already written at [ctx, ctx + chunk); ctx_lens: (S,) int32 tokens
    cached BEFORE each chunk.  Query row r of segment s sits at
    ``ctx_lens[s] + r``.  Returns (S, Sq, H, hd) in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    check_tensor("q", q, dev, q.dtype, 4)
    check_tensor("k_cache", k_cache, dev, q.dtype, 4)
    check_tensor("v_cache", v_cache, dev, q.dtype, 4)
    check_tensor("ctx_lens", ctx_lens, dev, torch.int32, 1)
    s, sq, h, hd = q.shape
    _, smax, hkv, hd_k = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != s
            or hd_k != hd or ctx_lens.shape[0] != s):
        raise ValueError(f"shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"ctx_lens {tuple(ctx_lens.shape)} do not match")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    err = build.library().proserve_packed_prefill(
        DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(), s, sq, h,
        hkv, hd, smax, 1.0 / math.sqrt(hd),
        device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "packed_prefill_attention")
    build.count_launch(packed_prefill_attention)
    return out


packed_prefill_attention.launches = 0
