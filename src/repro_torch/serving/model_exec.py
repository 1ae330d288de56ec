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
* ``DecodeGraphs``   — ``decode_step`` captured into one CUDA graph per
  batch bucket and replayed: the engine's fused decode on the card.
* ``moe_work``       — a call's routed slots and expert rows, from shapes.

The reference scans over stacked layers inside ``jax.jit`` with the pool
donated; here a Python loop over layers updates the pool tensor IN PLACE
(``index_put_`` on the (L, 2, N, bs, Hkv, hd) pool replaces JAX's
functional ``.at[].set`` with donation), so the functions return the same
pool object they were given.  The shape buckets below are copied
unchanged: eager PyTorch needs no compile cache, but the buckets fix the
padding the kernels see (pad rows write null block 0, pad queries go to
the extra row ``S``), and ``DecodeGraphs`` keys its graphs on the batch
bucket.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..kernels import build
from ..kernels.ops import (chunked_prefill_attention,
                           packed_prefill_attention, packed_verify_attention,
                           paged_decode_attention)
from ..models.layers import apply_norm, apply_rope
from ..models.model import ArchConfig, _ffn, _qkv, layer_params
from ..models.moe import capacity

# the families whose layers are attention + feed-forward, all of their
# KV in the paged pool.  The feed-forward (``_ffn``: routed experts or
# the dense MLP) computes MoE capacity per batch row, so the activation
# shapes below decide it: (R, 1, d) for decode and verify (per request),
# (1, c, d) for a chunk, (1, t_b, d) for the packed stream with its
# padding (padding tokens route like any other).
PAGED_FAMILIES = ("dense", "moe")


def require_paged(cfg: ArchConfig) -> None:
    """The paged engine serves the attention families.  An SSM layer has
    no attention (its state is not paged KV), a hybrid layer would run
    its attention half only, an enc-dec decoder needs its cross-attention
    cache: those are served by ``models.model``'s ``prefill`` /
    ``decode_step``."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"the paged engine serves the {' and '.join(PAGED_FAMILIES)} "
            f"families; {cfg.name!r} is {cfg.family!r}")


def moe_work(cfg: ArchConfig, rows: int, seq: int, tokens: int) -> dict:
    """A call's routed-expert work, from shapes, summed over the layers:
    ``moe_routed``, the slots its ``tokens`` real tokens route (tokens x
    top_k), and ``moe_rows``, the rows its expert GEMMs compute over the
    (rows, seq) activations it runs, padding included (E x C x rows, C the
    capacity of a row of ``seq`` tokens).  Empty for a model without
    routed layers."""
    if cfg.family != "moe":
        return {}
    cap = capacity(cfg.top_k, seq, cfg.n_experts, cfg.capacity_factor)
    return {"moe_routed": cfg.n_layers * tokens * cfg.top_k,
            "moe_rows": cfg.n_layers * cfg.n_experts * cap * rows}


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
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp["attn"], h)
        q, k = _rope(cfg, q, k, positions)
        layer_kv = pool_kv[li]
        # write the new K/V into each row's current block slot
        layer_kv[0, block_of, slot_of] = k[:, 0]
        layer_kv[1, block_of, slot_of] = v[:, 0]
        o = attend(q[:, 0].contiguous(), layer_kv[0], layer_kv[1], lens1)
        x = x + (o.reshape(r, -1) @ lp["attn"]["wo"])[:, None]
        h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm, cfg.norm_eps)
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


def grown_width(width: int, widest: int) -> int:
    """``DecodeGraphs``' table width after a batch whose widest table row
    holds ``widest`` blocks: ``width`` while the row fits, else the row's
    ``table_bucket``.  It only grows."""
    return width if widest <= width else table_bucket(widest)


# one capture under way in the process at a time (replicas on one card
# capture from their own driver threads)
_CAPTURE_LOCK = threading.Lock()


class _Bucket:
    """One batch bucket's static input (tokens (b,) | lengths (b,) |
    table (b, W) int32, in one device buffer and its pinned host copy)
    and its graph."""
    __slots__ = ("host", "dev", "graph", "out", "launches", "kv_ptr")

    def __init__(self, n: int, device: torch.device):
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(n, dtype=torch.int32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Counter = Counter()
        self.kv_ptr = 0


class DecodeGraphs:
    """``decode_step`` captured into CUDA graphs and replayed: one graph
    per batch bucket (``seg_bucket``), all at one table width, so a step
    is one graph launch instead of a Python walk over the layers.

    * Width: ``fit`` keeps it until a batch's widest table row passes it,
      then moves it to that row's ``table_bucket`` (``grown_width``) and
      drops every graph.  The decode kernel reads a row's table only up
      to ceil(len / page), so a wider table changes neither its work nor
      its bits.
    * Inputs: ``upload`` writes a step's tokens, table and lengths into
      its bucket's pinned host buffer and copies it to the bucket's
      static device buffer in one transfer; the graph reads that buffer
      and writes its static (b,) int32 tokens.  The caller fetches the
      tokens before the next upload (the copy reads the pinned buffer
      asynchronously).
    * Capture: a bucket's first step runs eagerly on a side stream
      (``warm``): that run is the step itself, and it sets the kernels'
      shared-memory limits and runs cuBLAS's heuristics.  ``capture``
      then records the same call on that stream in thread-local mode
      (another thread, such as the transfer lanes' worker, may go on
      issuing copies and querying events), into one memory pool that
      every bucket shares: replays are serial on the caller's stream.
      A graph holds the pool tensor's address; at another address the
      bucket is captured again.  A width change takes a new memory pool.
    * Launch counts: the kernels a capture records are counted once per
      replay (``build.recording``), so ``ops.launch_counts()`` stays
      exact.
    """

    def __init__(self, cfg: ArchConfig, params: dict, width: int,
                 device):
        self.cfg, self.params, self.width = cfg, params, width
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.mempool = torch.cuda.graph_pool_handle()
        self._buckets: dict[int, _Bucket] = {}

    def fit(self, widest: int) -> int:
        """The table width for a batch whose widest row holds ``widest``
        blocks; the graphs are dropped when it grows."""
        width = grown_width(self.width, widest)
        if width != self.width:
            self.width = width
            self._buckets.clear()
            # a pool whose graphs are all gone cannot take a capture again
            self.mempool = torch.cuda.graph_pool_handle()
        return width

    def upload(self, tokens: np.ndarray, table: np.ndarray,
               lens: np.ndarray) -> None:
        """tokens, lens: (b,) int32 host arrays of a batch bucket b;
        table: (b, width) int32."""
        b = len(tokens)
        if table.shape != (b, self.width):
            raise ValueError(f"table {table.shape} is not ({b}, "
                             f"{self.width})")
        bk = self._buckets.get(b)
        if bk is None:
            bk = self._buckets[b] = _Bucket(b * (2 + self.width),
                                            self.device)
        h = bk.host.numpy()
        h[:b] = tokens
        h[b:2 * b] = lens
        h[2 * b:] = table.reshape(-1)
        bk.dev.copy_(bk.host, non_blocking=True)

    def _inputs(self, b: int) -> tuple:
        dev = self._buckets[b].dev
        return dev[:b], dev[2 * b:].view(b, self.width), dev[b:2 * b]

    def ready(self, b: int, pool_kv: torch.Tensor) -> bool:
        """Bucket ``b`` has a graph over this pool tensor."""
        bk = self._buckets[b]
        return bk.graph is not None and bk.kv_ptr == pool_kv.data_ptr()

    def replay(self, b: int) -> torch.Tensor:
        """One replay on the current stream; its (b,) int32 tokens."""
        bk = self._buckets[b]
        bk.graph.replay()
        build.add_launches(bk.launches)
        return bk.out

    def warm(self, b: int, pool_kv: torch.Tensor) -> torch.Tensor:
        """The step run eagerly on the side stream, ordered after the
        upload and before whatever the current stream does next."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            toks, _ = decode_step(self.cfg, self.params, pool_kv,
                                  *self._inputs(b))
        cur.wait_stream(self.stream)
        return toks

    def capture(self, b: int, pool_kv: torch.Tensor) -> None:
        """Record bucket ``b``'s step into its graph (after ``warm``);
        nothing runs.  A graph it replaces goes only after the capture,
        which keeps the shared pool alive."""
        bk = self._buckets[b]
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.stream(self.stream), \
                build.recording() as launches:
            graph.capture_begin(pool=self.mempool,
                                capture_error_mode="thread_local")
            try:
                out, _ = decode_step(self.cfg, self.params, pool_kv,
                                     *self._inputs(b))
            finally:
                graph.capture_end()
        bk.graph, bk.out, bk.launches = graph, out, launches
        bk.kv_ptr = pool_kv.data_ptr()


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
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
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
        h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm, cfg.norm_eps)
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
    t_len = tokens.shape[1]
    n_seg = tables.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.hd
    x = params["embed"][tokens.long()].to(pool_kv.dtype)     # (1, T, d)
    q_rows, q_cols = q_rows.long(), q_cols.long()
    sblocks, sslots = scatter_blocks.long(), scatter_slots.long()
    stage = tables.long()
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
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
        h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm, cfg.norm_eps)
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
