"""Paged decode attention: the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (port of ``repro.kernels.paged_attention``).

``paged_decode_attention`` launches the kernel on CUDA tensors and raises
on anything it does not take; ``repro_torch.kernels.ops`` dispatches CPU
tensors to the plain version in ``ref.py``.  ``paged_decode_attention.
launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims that paged_attention.cu and packed_prefill.cu instantiate:
# every head_dim of a config in ``configs/`` (any G = H / Hkv is taken)
HEAD_DIMS = (8, 16, 32, 64, 128)


def check_tensor(name: str, t: torch.Tensor, device: torch.device,
                 dtype=None, ndim: int | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def check_paged(q, k_pages, v_pages, block_tables, lengths) -> None:
    """The checks both entries of ``csrc/paged_attention.cu`` share: q
    (rows, H, hd) and the (P, page, Hkv, hd) pages of one CUDA device and
    dtype, contiguous, H a multiple of Hkv, head_dim in ``HEAD_DIMS``, the
    pages 16-byte aligned (the kernel copies their rows in 16-byte
    pieces); int32 tables and lengths there too."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    check_tensor("q", q, dev, q.dtype, 3)
    check_tensor("k_pages", k_pages, dev, q.dtype, 4)
    check_tensor("v_pages", v_pages, dev, q.dtype, 4)
    check_tensor("block_tables", block_tables, dev, torch.int32, 2)
    check_tensor("lengths", lengths, dev, torch.int32, 1)
    h, hd = q.shape[1:]
    _, page, hkv, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {q.shape}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if hd not in HEAD_DIMS or page < 1:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS} or page {page} "
                         f"< 1")
    if any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError("k_pages / v_pages must be 16-byte aligned")


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, H, hd); k/v_pages: (P, page, Hkv, hd); block_tables:
    (B, maxp) int32 (pad with 0); lengths: (B,) int32.  Returns (B, H, hd)
    in q's dtype (float32, or bfloat16 with float32 math)."""
    check_paged(q, k_pages, v_pages, block_tables, lengths)
    b, h, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    if block_tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError("block_tables / lengths rows must equal B")
    dev = q.device
    out = torch.empty_like(q)
    err = build.library().proserve_paged_decode(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, hkv, hd, page, block_tables.shape[1],
        1.0 / math.sqrt(hd), device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_decode_attention")
    build.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0


def launch_shape(dtype: torch.dtype, hd: int, group: int,
                 device: torch.device) -> dict:
    """How the kernel instance for (dtype, head_dim, G) launches on
    ``device``: blocks per cluster, warps per block, cp.async stages per
    warp, positions per stage, dynamic shared memory per block, resident
    blocks per SM, resident clusters (-1 where the occupancy query fails)
    and head groups per (row, kv head): a G above 8 runs in groups of 8
    query heads, each its own cluster.  Launches nothing."""
    out = (ctypes.c_int * 8)()
    err = build.library().proserve_paged_decode_info(
        DTYPES[dtype], hd, group, device_index(device), ctypes.addressof(out))
    build.check(err, "paged_decode_attention launch_shape")
    keys = ("cluster", "warps", "stages", "positions_per_stage",
            "smem_bytes", "blocks_per_sm", "clusters", "head_groups")
    return dict(zip(keys, out))
