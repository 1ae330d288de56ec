"""Packed speculative-verify attention: the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` entered through ``proserve_packed_verify``
(port of ``repro.kernels.spec_verify``).

The verify rows of one request (its draft positions j = 0..depth) share
the request's row of a compact (S, maxp) block table: ``row_seg`` maps
each row to it, and row j's length ``l_kv + j + 1`` hides the same-launch
writes of the rows after it.  The kernel is the paged decode kernel with
that one change, so each row is bitwise the decode row run on
``block_tables[row_seg]``.

``row_seg`` is checked against ``[0, S)`` on the host before the launch
(pass it as a CPU tensor, as the engine does; a CUDA tensor is fetched for
the check, a synchronisation) and uploaded on the caller's stream.  The
wrapper raises on anything the kernel does not take;
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
``packed_verify_attention.launches`` counts the launches.
"""
from __future__ import annotations

import math

import torch

from . import build
from .paged_attention import DTYPES, check_paged, device_index


def packed_verify_attention(q, k_pages, v_pages, block_tables, lengths,
                            row_seg):
    """q: (R, H, hd), one row per (request, draft position); k/v_pages:
    (P, page, Hkv, hd); block_tables: (S, maxp) int32 (pad with 0);
    lengths: (R,) int32 per row; row_seg: (R,) integer row -> table row in
    [0, S).  Returns (R, H, hd) in q's dtype."""
    check_paged(q, k_pages, v_pages, block_tables, lengths)
    seg = torch.as_tensor(row_seg)
    if seg.dtype not in (torch.int32, torch.int64) or seg.dim() != 1:
        raise TypeError(f"row_seg must be a 1-D integer tensor, got "
                        f"{seg.dtype} {tuple(seg.shape)}")
    r, h, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    n_seg = block_tables.shape[0]
    if lengths.shape[0] != r or seg.shape[0] != r:
        raise ValueError("lengths / row_seg rows must equal R")
    dev = q.device
    seg = seg.cpu()
    if r and (int(seg.min()) < 0 or int(seg.max()) >= n_seg):
        raise IndexError(f"row_seg out of range [0, {n_seg}): "
                         f"{seg.tolist()}")
    seg_dev = seg.to(torch.int32).to(dev, non_blocking=True)
    out = torch.empty_like(q)
    err = build.library().proserve_packed_verify(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        seg_dev.data_ptr(), out.data_ptr(), r, h, hkv, hd, page,
        block_tables.shape[1], 1.0 / math.sqrt(hd), device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "packed_verify_attention")
    build.count_launch(packed_verify_attention)
    return out


packed_verify_attention.launches = 0
