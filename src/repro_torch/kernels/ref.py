"""Plain PyTorch versions of the ported kernels (port of the oracles in
``repro.kernels.ref``).

Deliberately naive — gather everything, masked softmax in float32 — and
the function each CUDA kernel is held against: the CPU tests run these
(the serving path takes them for CPU tensors) and ``chip_smoke.py``
compares every kernel with them on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, H, hd); pages: (P, page, Hkv, hd); block_tables: (B, maxp);
    lengths: (B,).  Returns (B, H, hd)."""
    b, h, hd = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = h // hkv
    maxp = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].reshape(b, maxp * page, hkv, hd).float()
    v = v_pages[idx].reshape(b, maxp * page, hkv, hd).float()
    q4 = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", q4, k) / math.sqrt(hd)
    pos = torch.arange(maxp * page, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(b, h, hd).to(q.dtype)


def packed_verify_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                row_seg):
    """Packed speculative verify: rows sharing a request share a block-table
    row via ``row_seg``.  q: (R, H, hd); pages: (P, page, Hkv, hd);
    block_tables: (S, maxp); lengths / row_seg: (R,).  The decode math on
    each row's gathered table.  Returns (R, H, hd)."""
    seg = torch.as_tensor(row_seg).to(device=block_tables.device,
                                      dtype=torch.long)
    return paged_decode_attention_ref(q, k_pages, v_pages,
                                      block_tables[seg], lengths)


def chunked_prefill_attention_ref(q, k_cache, v_cache, cache_lens):
    """The chunk's K/V are ALREADY written into the cache at
    [cache_lens - Sq, cache_lens).  q: (B, Sq, H, hd); k/v_cache:
    (B, Smax, Hkv, hd); cache_lens: (B,) valid tokens INCLUDING the chunk.
    Query row j sits at cache_lens - Sq + j and attends causally.
    Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    q5 = q.reshape(b, sq, hkv, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", q5, k_cache.float())
    s = s / math.sqrt(hd)
    q_pos = (cache_lens[:, None] - sq
             + torch.arange(sq, device=q.device)[None, :])        # (B, Sq)
    k_pos = torch.arange(smax, device=q.device)[None, :]
    mask = k_pos[:, None, :] <= q_pos[..., None]                  # (B,Sq,Smax)
    s = s.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def packed_prefill_attention_ref(q, k_cache, v_cache, ctx_lens):
    """Packed prefill: segment s's query row r sits at ctx_lens[s] + r, so
    this is ``chunked_prefill_attention_ref`` with
    ``cache_lens = ctx_lens + Sq``.  q: (S, Sq, H, hd); k/v_cache:
    (S, Smax, Hkv, hd); ctx_lens: (S,).  Returns (S, Sq, H, hd)."""
    return chunked_prefill_attention_ref(q, k_cache, v_cache,
                                         ctx_lens + q.shape[1])


def block_gather_ref(pool, indices, block_dim: int = 0):
    """Blocks ``indices`` of ``pool``'s axis ``block_dim``, moved to the
    front: pool (P, page, ...) -> (n, page, ...) for ``block_dim = 0``
    (the JAX form); the port's pool (L, 2, N, bs, Hkv, hd) with
    ``block_dim = 2`` -> (n, L, 2, bs, Hkv, hd)."""
    idx = torch.as_tensor(indices).to(device=pool.device, dtype=torch.long)
    return pool[(slice(None),) * block_dim + (idx,)].movedim(block_dim, 0)


def kv_block_quantize_ref(blocks):
    """Symmetric int8 per-(block, layer, k|v)-plane quantization.
    blocks: (n, L, 2, bs, Hkv, hd) float -> (int8 vals same shape, fp32
    scales (n, L, 2)).  The expression shapes are the reference's
    (``x * inv``, the fp32 constant 1/127, round half to even), so the
    result is bitwise that of ``repro.kernels.ref.kv_block_quantize_ref``."""
    n, lyr, two = blocks.shape[:3]
    x = blocks.reshape(n * lyr * two, -1).float()
    scale = x.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0)
    inv = torch.where(scale > 0.0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv), -127.0, 127.0).to(torch.int8)
    return q.reshape(blocks.shape), scale.reshape(n, lyr, two)


def kv_block_dequantize_ref(vals, scales):
    """vals: (n, L, 2, bs, Hkv, hd) int8, scales: (n, L, 2) fp32 -> fp32
    blocks; |x - dequant(quant(x))| <= scale / 2 per element."""
    n, lyr, two = vals.shape[:3]
    q = vals.reshape(n * lyr * two, -1)
    out = q.float() * scales.reshape(n * lyr * two, 1)
    return out.reshape(vals.shape)
