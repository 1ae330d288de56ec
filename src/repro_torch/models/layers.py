"""Shared neural building blocks on torch tensors (port of
``repro.models.layers``).

Plain functions, same names, same layouts and the same float32 upcasts as
the JAX reference: attention tensors are ``(B, S, heads, head_dim)`` and
normalisation computes in float32 before casting back.  Only the dense
attention core is ported; the serving path's attention runs in the
kernels of ``repro_torch.kernels``.
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


# --------------------------------------------------------------------------
# attention core
# --------------------------------------------------------------------------

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
