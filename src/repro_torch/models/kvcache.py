"""Contiguous KV caches for ``models.model``'s ``prefill`` /
``decode_step`` (port of ``repro.models.kvcache``).

The serving engine keeps its KV in the paged pool
(``serving/kv_pool.py``); these per-request caches serve the model-level
entry points.  Hybrid archs carry a ring-buffer window cache plus SSM
state; pure SSM archs carry state only.  Where the reference returns
new arrays, the updates here write the given tensors IN PLACE and return
them.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .layers import placed, shard_index


def init_attn_cache(n_layers: int, batch: int, max_seq: int,
                    n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                    device="cpu") -> dict:
    shape = (n_layers, batch, max_seq, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _insert(k_cache, v_cache, k_new, v_new, slots):
    if isinstance(k_cache, DTensor):
        return _insert_masked(k_cache, v_cache, k_new, v_new, slots)
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    k_cache[b_idx, slots] = k_new.to(k_cache.dtype)
    v_cache[b_idx, slots] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _insert_masked(k_cache, v_cache, k_new, v_new, slots):
    """One new position per row into DTensor caches, written by each rank
    into its own (batch, position) shard of the caches' local tensors:
    the position is selected by a mask (exact: a select) and copied back
    in place.  DTensor refuses an in-place scatter into a sharded dim,
    and left to itself torch 2.11's DTensor moves the whole cache to
    another split and back (two all-to-alls a layer) for the masked
    write."""
    if k_new.shape[1] != 1:
        raise ValueError("a DTensor cache takes one new position per row")
    mesh = k_cache.device_mesh
    seq = [i for i, p in enumerate(k_cache.placements) if p.is_shard(1)]
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in k_cache.placements)
    slots = placed(slots, mesh, rows).to_local()
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        local, new = cache.to_local(), placed(new, mesh, rows).to_local()
        pos = torch.arange(local.shape[1], device=local.device) \
            + shard_index(mesh, seq) * local.shape[1]
        hit = (pos[None, :] == slots)[..., None, None]      # (B, S, 1, 1)
        local.copy_(torch.where(hit, new.to(local.dtype), local))
    return k_cache, v_cache


def update_layer_cache(k_cache, v_cache, k_new, v_new, lengths):
    """Insert (B, S_new, Hkv, D) at per-batch offsets into (B, Smax, ...)."""
    s_new = k_new.shape[1]
    idx = lengths.long()[:, None] + torch.arange(s_new,
                                                 device=k_new.device)[None]
    return _insert(k_cache, v_cache, k_new, v_new, idx)


def update_ring_cache(k_cache, v_cache, k_new, v_new, lengths, window: int):
    """Ring-buffer insert for sliding-window caches (slot = pos % window)."""
    s_new = k_new.shape[1]
    pos = lengths.long()[:, None] + torch.arange(s_new,
                                                 device=k_new.device)[None]
    return _insert(k_cache, v_cache, k_new, v_new, pos % window)


__all__ = ["init_attn_cache", "update_layer_cache", "update_ring_cache"]
