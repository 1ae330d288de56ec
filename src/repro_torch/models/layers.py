"""Shared neural building blocks on torch tensors (port of
``repro.models.layers``).

Plain functions, same names, same layouts and the same float32 upcasts as
the JAX reference: attention tensors are ``(B, S, heads, head_dim)`` and
normalisation computes in float32 before casting back.  The serving
path's attention runs in the kernels of ``repro_torch.kernels``;
``dense_attention`` / ``chunked_attention`` are the full-sequence cores
of ``models.model``'s ``forward`` and ``decode_attention`` the core of
its ``decode_step``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dtype) * scale + bias


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# --------------------------------------------------------------------------
# rotary embeddings (full, partial and none)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float = 1e4,
                     device=None) -> tuple[torch.Tensor, int]:
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (theta ** exps)
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               fraction: float = 1.0, theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    inv, rot = rope_frequencies(head_dim, fraction, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions.float()[..., None] * inv                  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(1e4, dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : (d // 2)])
    return pe.to(dtype)


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)

def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    window: int = 0) -> torch.Tensor:
    """Reference attention.

    q: (B, Sq, H, D);  k, v: (B, Skv, Hkv, D).  ``q_offset``: absolute
    position of q[0]; ``kv_len``: per-batch valid KV length; ``window``:
    sliding-window size (0 = full).  GQA contracts against the un-repeated
    K/V, as the reference does.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q5 = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k) / math.sqrt(d)
    scores = scores.float()
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :]) if causal else \
        torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if window > 0:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    scores = scores.masked_fill(~mask, NEG_INF)
    if kv_len is not None:
        valid = k_pos[None, :] < kv_len[:, None]              # (B, Skv)
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return o.reshape(b, sq, h, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, q_offset: int = 0,
                      window: int = 0, kv_chunk: int = 512) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with an online softmax,
    so the (Sq, Skv) score matrix is never materialized.  Assumes
    un-padded contiguous KV."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    nchunks = -(-skv // kv_chunk)
    pad = nchunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(sq, device=q.device) + q_offset
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kb = _repeat_kv(k[:, ci * kv_chunk:(ci + 1) * kv_chunk], groups)
        vb = _repeat_kv(v[:, ci * kv_chunk:(ci + 1) * kv_chunk], groups)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        k_pos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)
        mask = (k_pos[None, :] < skv).expand(sq, kv_chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)                    # (B,Sq,H,D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-step decode over a padded contiguous cache.

    q: (B, 1, H, D); caches: (B, Smax, Hkv, D); kv_len: (B,) valid
    lengths.  With ``window`` > 0 only the trailing ``window`` positions
    attend.  GQA contracts q as (B, Hkv, G, D) against the un-repeated
    cache."""
    b, _, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    q5 = q.reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", q5, k_cache).float()
    s = s / math.sqrt(d)                                      # (B,Hkv,G,Skv)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    valid = k_pos < kv_len[:, None]
    if window > 0:
        valid = valid & (k_pos >= kv_len[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype), v_cache)
    o = o / l[..., 0][..., None].to(q.dtype)
    return o.reshape(b, 1, h, d)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape: tuple, scale: float,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """N(0, 1) * ``scale``, drawn in fp32 and cast to ``dtype`` (the
    reference's ``dense_init``; its fan-in scale is passed explicitly,
    since the port stacks layers on a leading axis)."""
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device) * scale
    return t.to(dtype)
