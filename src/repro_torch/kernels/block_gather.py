"""KV-block gather: the wrapper of the CUDA kernel ``csrc/block_gather.cu``
(port of ``repro.kernels.block_gather``).

``block_gather(pool, indices, block_dim)`` returns the blocks
``indices`` of ``pool``'s axis ``block_dim``, moved to the front and
contiguous: ``block_dim = 0`` is the JAX form, pool (P, page, Hkv, hd) ->
(n, page, Hkv, hd); the port's pool (L, 2, N, bs, Hkv, hd) with
``block_dim = 2`` gives the (n, L, 2, bs, Hkv, hd) offload snapshot in
one launch.  Bitwise a copy.

The indices are checked against the block count on the host before the
launch (pass them as a CPU tensor; a CUDA tensor is fetched for the
check, a synchronisation).  The wrapper launches on the caller's current
stream and raises on anything the kernel does not take;
``repro_torch.kernels.ops`` sends a CPU pool to the plain version.
``block_gather.launches`` counts the launches.
"""
from __future__ import annotations

import math

import torch

from . import build
from .paged_attention import check_tensor, device_index


def block_gather(pool: torch.Tensor, indices, block_dim: int = 0):
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    check_tensor("pool", pool, dev)
    if not 0 <= block_dim < pool.dim():
        raise ValueError(f"block_dim {block_dim} outside pool of "
                         f"{pool.dim()} dims")
    idx = torch.as_tensor(indices)
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError(f"indices must be a 1-D integer tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    idx = idx.cpu()
    n_blocks = pool.shape[block_dim]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_blocks):
        raise IndexError(f"block index out of range [0, {n_blocks}): "
                         f"{idx.tolist()}")
    planes = math.prod(pool.shape[:block_dim])
    row_bytes = math.prod(pool.shape[block_dim + 1:]) * pool.element_size()
    out = torch.empty((idx.numel(),) + tuple(pool.shape[:block_dim])
                      + tuple(pool.shape[block_dim + 1:]), dtype=pool.dtype,
                      device=dev)
    idx_dev = idx.to(torch.int32).to(dev, non_blocking=True)
    err = build.library().proserve_block_gather(
        pool.data_ptr(), idx_dev.data_ptr(), out.data_ptr(), idx.numel(),
        planes, n_blocks, row_bytes, device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "block_gather")
    build.count_launch(block_gather)
    return out


block_gather.launches = 0
