"""Operations and bytes that the served work needs, from shapes alone.

These count the model's work, not what an implementation executes: a
decode row reads its own context (not the padded table), and logits are
needed only where a token is sampled.  Every input byte is counted read once and every output byte
written once.  fp32: 4 bytes an element.
"""
from __future__ import annotations

F32 = 4


def layer_params(arch) -> int:
    """Matmul parameters of one layer that every token uses: in a routed
    layer the router, its ``top_k`` experts and the shared experts."""
    d, hd = arch.d_model, arch.hd
    attn = d * hd * (arch.n_heads + 2 * arch.n_kv_heads) \
        + arch.n_heads * hd * d
    if arch.family == "moe":
        return attn + d * arch.n_experts \
            + (arch.top_k + arch.n_shared) * 3 * d * arch.d_expert
    return attn + 3 * d * arch.d_ff


def moe_ffn(arch, tokens: int, experts_hit: int) -> tuple:
    """(FLOPs, bytes) of one layer's routed FFN call over ``tokens``
    tokens: the router, each token's ``top_k`` experts and the shared
    experts; bytes are the weights of the router, the shared experts and
    the ``experts_hit`` distinct experts that took at least one token,
    and the activations in and out.  A lower bound: a kernel that
    computes a slot it then drops, or reads an expert twice, reads
    below 100 % of it."""
    d, f = arch.d_model, arch.d_expert
    per_tok = d * arch.n_experts \
        + (arch.top_k + arch.n_shared) * 3 * d * f
    weights = d * arch.n_experts + (experts_hit + arch.n_shared) * 3 * d * f
    return 2 * tokens * per_tok, (weights + 2 * tokens * d) * F32


def attn_flops(arch, keys: int) -> int:
    """One query row of one layer against ``keys`` keys: QK^T and PV."""
    return 4 * arch.n_heads * arch.hd * keys


def rows_flops(arch, rows) -> int:
    """Model FLOPs of one engine call: ``rows`` is [(context before, tokens
    computed, logits needed)], one entry per request; queries are causal
    (token j of a chunk sees ``context + j + 1`` keys)."""
    per_tok = 2 * arch.n_layers * layer_params(arch)
    head = 2 * arch.d_model * arch.vocab
    total = 0
    for ctx, n, sample in rows:
        keys = n * ctx + n * (n + 1) // 2
        total += n * per_tok + arch.n_layers * attn_flops(arch, keys)
        total += head if sample else 0
    return total


def decode_attention(arch, ctx_lens) -> tuple:
    """(FLOPs, bytes) of one paged-decode launch (one layer): each row
    reads its own ``ctx + 1`` keys and values, its query, writes its
    output, and reads its length and the table entries it uses."""
    hkv, h, hd = arch.n_kv_heads, arch.n_heads, arch.hd
    flops = sum(attn_flops(arch, c + 1) for c in ctx_lens)
    kv = sum(c + 1 for c in ctx_lens) * 2 * hkv * hd * F32
    qo = len(ctx_lens) * 2 * h * hd * F32
    meta = sum(1 + -(-(c + 1) // 16) for c in ctx_lens) * 4
    return flops, kv + qo + meta


def prefill_attention(arch, rows) -> tuple:
    """(FLOPs, bytes) of one packed-prefill launch (one layer) over
    segments [(context before, tokens)]: causal queries over the chunk and
    its cached context; each segment's keys and values read once."""
    hkv, h, hd = arch.n_kv_heads, arch.n_heads, arch.hd
    flops = bytes_ = 0
    for ctx, n, _ in rows:
        flops += attn_flops(arch, n * ctx + n * (n + 1) // 2)
        bytes_ += (ctx + n) * 2 * hkv * hd * F32 + n * 2 * h * hd * F32 + 4
    return flops, bytes_


def bound_s(flops: float, bytes_: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / peaks["fp32_flops_per_s"],
               bytes_ / peaks["bytes_per_s"])
