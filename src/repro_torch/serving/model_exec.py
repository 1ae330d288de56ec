"""Model execution against the paged KV pool (port of
``repro.serving.model_exec``).

* ``decode_step``    — one token for B requests: per layer, project QKV,
  write the new K/V into each request's current block slot, run paged
  decode attention, and return the greedy argmax tokens (B,).
  ``decode_batch`` is the same forward returning the logits (B, V) (the
  engine's ``fused_decode=False`` path).
* ``verify_step``    — speculative verify: the decode forward over one row
  per (request, draft position), the rows of a request sharing its block
  table row through ``row_seg``, attention by the packed verify kernel.
* ``prefill_packed`` — several requests' prefill chunks concatenated into
  ONE flat token stream: dense ops run on the stream, attention regroups
  queries per segment and runs the packed prefill kernel.
* ``prefill_chunk``  — one request's chunk (the draft's prompt ingest and
  the engine's ``packed_prefill=False`` path): stage the request's blocks
  contiguously and run the chunked prefill kernel.

The reference scans over stacked layers inside ``jax.jit`` with the pool
donated; here a Python loop over layers updates the pool tensor IN PLACE
(``index_put_`` on the (L, 2, N, bs, Hkv, hd) pool replaces JAX's
functional ``.at[].set`` with donation), so the functions return the same
pool object they were given.  The shape buckets below are copied
unchanged: eager PyTorch needs no compile cache, but the buckets fix the
padding the kernels see (pad rows write null block 0, pad queries go to
the extra row ``S``), and a later CUDA-graph cache will key on them.
"""
from __future__ import annotations

import torch

from ..kernels.ops import (chunked_prefill_attention,
                           packed_prefill_attention, packed_verify_attention,
                           paged_decode_attention)
from ..models.layers import apply_norm, apply_rope, gelu_mlp, swiglu
from ..models.model import ArchConfig, _qkv, layer_params, require_dense


def _mlp(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, lp["mlp"]) if cfg.act == "swiglu" \
        else gelu_mlp(h, lp["mlp"])


def _rope(cfg: ArchConfig, q, k, positions):
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k


def _one_token_forward(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                       tokens: torch.Tensor, write_tables: torch.Tensor,
                       lens: torch.Tensor, attend) -> torch.Tensor:
    """The forward shared by decode and verify.  tokens: (R,) int32;
    write_tables: (R, maxp) the table row each token's K/V goes through;
    lens: (R,) int32 context BEFORE the token.  Per layer every row's K/V
    is written in place BEFORE attention, then ``attend(q, k_pages,
    v_pages, lens + 1)`` reads it back.  Returns the logits (R, V)."""
    require_dense(cfg)
    r = tokens.shape[0]
    bs = pool_kv.shape[3]
    x = params["embed"][tokens.long()][:, None, :].to(pool_kv.dtype)
    positions = lens[:, None]
    rows = torch.arange(r, device=tokens.device)
    block_of = write_tables[rows, (lens // bs).long()].long()    # (R,)
    slot_of = (lens % bs).long()
    lens1 = lens + 1
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = _qkv(cfg, lp["attn"], h)
        q, k = _rope(cfg, q, k, positions)
        layer_kv = pool_kv[li]
        # write the new K/V into each row's current block slot
        layer_kv[0, block_of, slot_of] = k[:, 0]
        layer_kv[1, block_of, slot_of] = v[:, 0]
        o = attend(q[:, 0].contiguous(), layer_kv[0], layer_kv[1], lens1)
        x = x + (o.reshape(r, -1) @ lp["attn"]["wo"])[:, None]
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + _mlp(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    return (x @ params["lm_head"].T)[:, 0]


def _decode_forward(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                    tokens: torch.Tensor, tables: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,) int32; tables: (B, maxp) int32; lens: (B,) int32
    context BEFORE this step.  Writes each row's K/V into ``pool_kv`` in
    place and returns the logits (B, V)."""
    return _one_token_forward(
        cfg, params, pool_kv, tokens, tables, lens,
        lambda q, kp, vp, ln: paged_decode_attention(q, kp, vp, tables, ln))


@torch.no_grad()
def decode_batch(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                 tokens: torch.Tensor, tables: torch.Tensor,
                 lens: torch.Tensor):
    """One token for B requests, returning the full logits for host-side
    sampling.  tokens: (B,) int32; tables: (B, maxp); lens: (B,) context
    BEFORE this step.  Returns (logits (B, V), the updated pool)."""
    return _decode_forward(cfg, params, pool_kv, tokens, tables, lens), \
        pool_kv


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                tokens: torch.Tensor, tables: torch.Tensor,
                lens: torch.Tensor):
    """Fused decode step: the decode forward with the greedy argmax on the
    device, so the host fetches (B,) int32 tokens, not (B, V) logits.

    The batch may be padded to a bucket (``seg_bucket``) and the table
    width to ``table_bucket``: padding rows carry token 0, length 0 and an
    all-zero table row, so their single K/V write lands in the reserved
    null block 0 and their token is garbage the caller discards.
    Returns ((B,) int32 tokens, the updated pool — the same tensor)."""
    logits = _decode_forward(cfg, params, pool_kv, tokens, tables, lens)
    return logits.argmax(-1).to(torch.int32), pool_kv


@torch.no_grad()
def verify_step(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                tokens: torch.Tensor, tables: torch.Tensor,
                lens: torch.Tensor, row_seg):
    """Fused speculative-verify step: the decode forward over an EXPANDED
    row set — one row per (request, draft position j), where row j
    carries the token at position l_kv + j and ``lens`` = l_kv + j — with
    the greedy argmax of every row in one launch.

    tokens / lens / row_seg: (R,) int32 (row-bucket padded); tables:
    (S, maxp) int32 (segment-bucket padded), compact: ``row_seg`` maps each
    row to its request's table row (pass it as a CPU tensor: the kernel's
    wrapper checks it on the host).  Within each layer every row's K/V is
    written before attention and row j's length l_kv + j + 1 covers
    exactly rows <= j of its request, so the packed rows reproduce
    sequential greedy decode.  Padding rows carry token 0, length 0 and
    point at an all-zero pad table row, so their K/V write lands in the
    null block 0.  Returns ((R,) int32 argmax tokens, the updated pool)."""
    seg = torch.as_tensor(row_seg)
    seg_host = seg.cpu()
    row_tables = tables[seg.to(tables.device).long()]           # (R, maxp)
    logits = _one_token_forward(
        cfg, params, pool_kv, tokens, row_tables, lens,
        lambda q, kp, vp, ln: packed_verify_attention(q, kp, vp, tables, ln,
                                                      seg_host))
    return logits.argmax(-1).to(torch.int32), pool_kv


@torch.no_grad()
def prefill_chunk(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                  tokens: torch.Tensor, table: torch.Tensor,
                  ctx_len: torch.Tensor, max_ctx: int):
    """One request's chunk.  tokens: (1, c) int32 (pad with 0 to the
    bucket size); table: (1, maxp) int32 with maxp >= max_ctx / bs (pad
    with 0); ctx_len: (1,) int32 tokens already cached; ``max_ctx``: the
    staging span, a multiple of the block size and >= ctx + c.  Every
    token's K/V, the padding's too, is written through the request's table
    (positions past its blocks land in the null block 0); the first
    ``max_ctx / bs`` table entries are staged contiguously and the chunk
    attends to them with ``cache_lens = ctx + c``.  Returns (logits
    (1, c, V), the updated pool)."""
    require_dense(cfg)
    c = tokens.shape[1]
    bs = pool_kv.shape[3]
    hkv, hd = cfg.n_kv_heads, cfg.hd
    x = params["embed"][tokens.long()].to(pool_kv.dtype)      # (1, c, d)
    steps = torch.arange(c, device=tokens.device, dtype=ctx_len.dtype)
    positions = ctx_len[:, None] + steps[None, :]
    pos = positions[0]
    blocks = table[0, (pos // bs).long()].long()
    slots = (pos % bs).long()
    stage = table[0, :max_ctx // bs].long()
    cache_lens = ctx_len + c
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = _qkv(cfg, lp["attn"], h)
        q, k = _rope(cfg, q, k, positions)
        layer_kv = pool_kv[li]
        # write the chunk's K/V into the pool position by position
        layer_kv[0, blocks, slots] = k[0]
        layer_kv[1, blocks, slots] = v[0]
        # stage the context (gather blocks) into a contiguous buffer
        k_stage = layer_kv[0, stage].reshape(1, max_ctx, hkv, hd)
        v_stage = layer_kv[1, stage].reshape(1, max_ctx, hkv, hd)
        o = chunked_prefill_attention(q.contiguous(), k_stage, v_stage,
                                      cache_lens)
        x = x + o.reshape(1, c, -1) @ lp["attn"]["wo"]
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + _mlp(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    return x @ params["lm_head"].T, pool_kv


def staging_span(ctx: int, c: int, max_ctx: int, block_size: int) -> int:
    """Staging span of a ``prefill_chunk`` call of ``c`` tokens after
    ``ctx`` cached ones: the engine's ``max_ctx`` when the chunk fits in
    it, else ``ctx + c`` rounded up to whole blocks.  (The reference
    stages ``ctx + c`` unrounded there, which its reshape refuses unless
    it is a multiple of the block size.)"""
    span = ctx + c
    if span <= max_ctx:
        return max_ctx
    return -(-span // block_size) * block_size


@torch.no_grad()
def prefill_packed(cfg: ArchConfig, params: dict, pool_kv: torch.Tensor,
                   tokens, positions, q_rows, q_cols, scatter_blocks,
                   scatter_slots, tables, ctx_lens, last_idx, smax: int,
                   sq: int):
    """Packed multi-request prefill in one call.

      tokens:          (1, T) int32 flat stream, 0-padded to the T bucket
      positions:       (1, T) absolute position of each token (pad: 0)
      q_rows / q_cols: (T,)  attention scatter target: segment row /
                       within-chunk offset.  Padding tokens point at the
                       extra row ``S`` so they never touch real queries.
      scatter_blocks / scatter_slots: (T,) physical KV destination of each
                       token (padding tokens write the null block 0)
      tables:          (S, smax // block_size) staging tables (pad rows: 0)
      ctx_lens:        (S,) tokens already cached before each chunk
      last_idx:        (S,) flat index of each segment's last real token
      smax, sq:        staging length / chunk-pad length

    Returns (last-position logits per segment (S, V), the updated pool)."""
    require_dense(cfg)
    t_len = tokens.shape[1]
    n_seg = tables.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.hd
    x = params["embed"][tokens.long()].to(pool_kv.dtype)     # (1, T, d)
    q_rows, q_cols = q_rows.long(), q_cols.long()
    sblocks, sslots = scatter_blocks.long(), scatter_slots.long()
    stage = tables.long()
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = _qkv(cfg, lp["attn"], h)
        q, k = _rope(cfg, q, k, positions)
        layer_kv = pool_kv[li]
        # one flat scatter writes every segment's chunk K/V
        layer_kv[0, sblocks, sslots] = k[0]
        layer_kv[1, sblocks, sslots] = v[0]
        # stage each segment's blocks (only the ones it needs)
        k_stage = layer_kv[0, stage].reshape(n_seg, smax, hkv, hd)
        v_stage = layer_kv[1, stage].reshape(n_seg, smax, hkv, hd)
        # regroup flat queries into the padded per-segment layout; the
        # extra row n_seg absorbs padding tokens
        q_pad = q.new_zeros((n_seg + 1, sq) + tuple(q.shape[2:]))
        q_pad[q_rows, q_cols] = q[0]
        o = packed_prefill_attention(q_pad[:n_seg], k_stage, v_stage,
                                     ctx_lens)
        o_ext = torch.cat([o, o.new_zeros((1,) + tuple(o.shape[1:]))])
        o_flat = o_ext[q_rows, q_cols]                        # (T, H, hd)
        x = x + (o_flat.reshape(t_len, -1) @ lp["attn"]["wo"])[None]
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + _mlp(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    # only each segment's LAST chunk token can be sampled
    x_last = x[0, last_idx.long()]                            # (S, d)
    return x_last @ params["lm_head"].T, pool_kv


def bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def _geom_bucket(n: int, lo: int) -> int:
    """Round up to the next {2^k, 1.5*2^k} step at or above ``lo``: pad
    waste is bounded at 1.33x while the number of distinct shapes stays
    logarithmic in n."""
    b = lo
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b <<= 1


def flat_bucket(n: int) -> int:
    """Bucket for the packed flat token stream: power-of-two steps up to
    2048, then geometric half-steps."""
    return bucket(n) if n <= 2048 else _geom_bucket(n, 2048)


def chunk_bucket(n: int) -> int:
    """Bucket for the packed per-segment pad length (sq) and staging span:
    power-of-two steps up to 128, then geometric half-steps."""
    return bucket(n) if n <= 128 else _geom_bucket(n, 128)


def table_bucket(p: int) -> int:
    """Bucket for the decode block-table width (maxp): {2^k, 1.5*2^k}
    steps from 4."""
    return _geom_bucket(p, 4)


def seg_bucket(s: int) -> int:
    """Bucket for the packed segment count: powers of two up to 8, then
    multiples of 8."""
    if s <= 8:
        b = 1
        while b < s:
            b <<= 1
        return b
    return -(-s // 8) * 8
