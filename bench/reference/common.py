"""Plain PyTorch pieces the references share, written from the published
descriptions (fp32; matmuls as the caller's TF32 setting leaves them)."""
from __future__ import annotations

import math

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over adjacent pairs (2i, 2i+1) of each head, angles
    ``pos * theta**(-2i/hd)`` in fp32.  x: (S, heads, hd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[:, None] * inv                       # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q (S, H, hd), k / v (S, Hkv, hd); query head h reads kv head
    h // (H / Hkv).  Returns (S, H * hd)."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    for i in range(h):                        # one head at a time: memory
        sc = (q[:, i] @ k[:, i].T) / math.sqrt(hd)
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, i] = torch.softmax(sc, dim=-1) @ v[:, i]
    return out.reshape(s, h * hd)


def swiglu(x, w_gate, w_up, w_down):
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def norm_heads(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """QK-norm of x (S, heads, hd): RMSNorm of each head where the scale
    has hd entries, of the whole projection (OLMoE's published QK-norm)
    where it has heads * hd."""
    if w.numel() == x.shape[-1]:
        return rmsnorm(x, w, eps)
    return rmsnorm(x.reshape(x.shape[0], -1), w, eps).reshape(x.shape)


def routed_ffn(spec: dict, m: dict, li: int, h: torch.Tensor) -> torch.Tensor:
    """One layer's routed experts on the normed input h (S, d), as the
    published MoE decoders (OLMoE, Qwen-MoE) describe them: each token's
    ``num_experts_per_tok`` experts of highest router logit (ties to the
    lower index), each gated by its softmax over all the experts' logits,
    renormalised over the chosen ones where ``norm_topk_prob`` (then the
    softmax over the chosen logits alone, as Mixtral's), and the gated sum
    of their SwiGLU outputs.  No shared experts."""
    k = spec["num_experts_per_tok"]
    logits = h @ m["router"][li]                           # (S, E)
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]
    gates = torch.softmax(logits, dim=-1).gather(1, idx)
    if spec.get("norm_topk_prob"):
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(logits.shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], m["w_gate"][li, e], m["w_up"][li, e],
                       m["w_down"][li, e])
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


def attention_block(spec: dict, a: dict, li: int, h: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """One layer's attention on the normed input h (S, d)."""
    d = spec["hidden_size"]
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd = spec.get("head_dim", d // nh)
    q, k, v = h @ a["wq"][li], h @ a["wk"][li], h @ a["wv"][li]
    if spec.get("qkv_bias"):
        q, k, v = q + a["bq"][li], k + a["bk"][li], v + a["bv"][li]
    q = q.reshape(-1, nh, hd)
    k = k.reshape(-1, nkv, hd)
    v = v.reshape(-1, nkv, hd)
    if spec.get("qk_norm"):
        q = norm_heads(q, a["q_norm"][li], spec["rms_norm_eps"])
        k = norm_heads(k, a["k_norm"][li], spec["rms_norm_eps"])
    q = rope(q, pos, spec["rope_theta"])
    k = rope(k, pos, spec["rope_theta"])
    return causal_attention(q, k, v) @ a["wo"][li]


def run(spec: dict, w: dict, tokens: torch.Tensor, rows: torch.Tensor,
        ffn) -> torch.Tensor:
    """The decoder over ``tokens`` (S,), layer by layer; logits (len(rows),
    V) at positions ``rows``.  ``ffn(li, h)`` is the family's FFN."""
    eps = spec["rms_norm_eps"]
    lay = w["layers"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = w["embed"][tokens]
    for li in range(spec["num_hidden_layers"]):
        x = x + attention_block(spec, lay["attn"], li,
                                rmsnorm(x, lay["ln1"]["scale"][li], eps), pos)
        x = x + ffn(li, rmsnorm(x, lay["ln2"]["scale"][li], eps))
    x = rmsnorm(x[rows], w["ln_f"]["scale"], eps)
    return x @ w["lm_head"].T
