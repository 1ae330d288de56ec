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
from torch.distributed.tensor import DTensor


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
    """One new position per row into DTensor caches.  DTensor refuses an
    in-place scatter into a sharded dim, so the position is written by a
    mask (exact: a select), each rank over its own batch and sequence
    shard, and copied back into the caches in place."""
    if k_new.shape[1] != 1:
        raise ValueError("a DTensor cache takes one new position per row")
    pos = torch.arange(k_cache.shape[1], device=k_cache.device)
    hit = (pos[None, :] == slots)[..., None, None]          # (B, Smax, 1, 1)
    k_cache.copy_(torch.where(hit, k_new.to(k_cache.dtype), k_cache))
    v_cache.copy_(torch.where(hit, v_new.to(v_cache.dtype), v_cache))
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
