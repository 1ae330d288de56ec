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
import torch.distributed._functional_collectives as funcol
import torch.utils._pytree as pytree
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

NEG_INF = -1e30
# the mesh axes a batch is split over (``ShardingPolicy.dp``)
DP_AXES = ("pod", "data")


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


def apply_norm(x: torch.Tensor, p: dict, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """``eps`` is the RMSNorm's (``ArchConfig.norm_eps``); a LayerNorm
    keeps the reference's 1e-5."""
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"], eps)


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

def splittable(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t``, ready to have ``dim`` split into (n, ...).  DTensor cannot
    split a dim that lies over a number of ranks that does not divide
    ``n`` (XLA splits it across the new dims): a DTensor split so is
    first gathered on that dim, on the mesh dims that split it."""
    if isinstance(t, DTensor):
        ranks = math.prod(t.device_mesh.size(i)
                          for i, p in enumerate(t.placements)
                          if p.is_shard(dim))
        if n % ranks:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard(dim) else p
                for p in t.placements])
    return t


def evenly_split(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a DTensor that DTensor's sharding propagation split
    unevenly (a dim over a number of ranks that does not divide it)
    gathered on that dim: DTensor cannot flatten such a dim into a
    matmul's rows."""
    if isinstance(t, DTensor) and any(
            p.is_shard() and t.shape[p.dim] % t.device_mesh.size(i)
            for i, p in enumerate(t.placements)):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_shard()
            and t.shape[p.dim] % t.device_mesh.size(i) else p
            for i, p in enumerate(t.placements)])
    return t


def split_back(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t``, a merge of a dim of ``n`` with others, whose backward must
    split the gradient again: DTensor cannot when the gradient arrives
    split over ranks that do not divide ``n``.  Under autograd, a DTensor
    whose mesh has such an axis comes out ``pinned``."""
    if isinstance(t, DTensor) and any(n % size
                                      for size in t.device_mesh.shape):
        t = pinned(t)
    return t


def pinned(t: torch.Tensor) -> torch.Tensor:
    """``t``; under autograd a DTensor comes out pinned, so that its
    gradient is first brought back to ``t``'s placements, a Partial sum's
    gradient whole (``from_local``'s backward redistributes it).  On a
    row-parallel projection's output this is the all-gather of Megatron's
    backward: the residual add that reduce-scatters the output onto the
    sequence hands its gradient back sequence-split, which the matmul's
    backward could not fold into rows."""
    if isinstance(t, DTensor) and t.requires_grad:
        t = DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                               shape=t.shape, stride=t.stride(),
                               run_check=False)
    return t


def batch_only(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a DTensor activation brought to its batch placement
    alone: dim 0 stays split over the data axes where it is, every other
    dim is whole on every rank (``P(dp, None, None)`` in the reference's
    terms).  Called where an activation meets a weight: the matmul folds
    (batch, sequence) into its rows, and DTensor (torch 2.11) refuses to
    fold a split sequence.  On a sequence-parallel residual this is
    Megatron's all-gather before a projection, the one XLA's partitioner
    inserts for the reference; its backward reduce-scatters."""
    if isinstance(t, DTensor):
        names = t.device_mesh.mesh_dim_names
        want = tuple(p if p.is_shard(0) and names[i] in DP_AXES
                     else Replicate() for i, p in enumerate(t.placements))
        if want != tuple(t.placements):
            t = t.redistribute(t.device_mesh, want)
    return t


def shard_index(mesh, dims) -> int:
    """This rank's shard among those that the mesh ``dims`` cut one
    tensor dim into (the first mesh dim major, as DTensor splits)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def placed(t, mesh, placements):
    """``t`` as a DTensor with ``placements``; a plain tensor holds the
    same global value on every rank (``steps._sharded``'s constants)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements)


def on_batch_shards(fn, n_out: int, params: dict, *acts):
    """``fn(params, *acts)``, whose ``n_out`` outputs lead with the batch.
    On DTensor activations each rank runs it on its own batch rows
    through ``local_map``: the activations (None passes) are brought to
    the batch split of the first (dim 0 over the data axes, whole
    elsewhere), ``params`` whole; the outputs leave in that split, and a
    parameter's gradient is the sum over the batch shards."""
    if not isinstance(acts[0], DTensor):
        return fn(params, *acts)
    mesh = acts[0].device_mesh
    names = mesh.mesh_dim_names
    rows = tuple(Shard(0) if p.is_shard(0) and names[i] in DP_AXES
                 else Replicate() for i, p in enumerate(acts[0].placements))
    whole = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if p.is_shard(0) else p for p in rows)
    leaves, spec = pytree.tree_flatten(params)
    n = len(leaves)

    def local(*flat):
        return fn(pytree.tree_unflatten(list(flat[:n]), spec), *flat[n:])

    act_p = tuple(None if a is None else rows for a in acts)
    return local_map(local, out_placements=(list(rows),) * n_out,
                     in_placements=(whole,) * n + act_p,
                     in_grad_placements=(summed,) * n + act_p,
                     device_mesh=mesh)(
        *(placed(t, mesh, whole) for t in leaves),
        *(None if a is None else placed(a, mesh, rows) for a in acts))


def _attention_on_shards(core, q, k, v, *, q_offset: int = 0,
                         **kw) -> DTensor:
    """A full-sequence core on DTensors: each rank runs the plain
    ``core`` on its own shard (``local_map``), so no dims of a split
    tensor are merged.  The shard is (batch, head) where the projection
    left q split over heads (Megatron's layout: no collective), else
    (batch, query row) where the query rows divide, the split of the
    reference's ``attn_scores`` hook, with the causal and window masks
    at the rows' global offset; k / v split over the heads with q, or
    whole with each rank taking the kv heads of its q heads.  The output
    keeps q's head split and never a row split, so ``wo`` folds whole
    rows."""
    mesh, sq, hkv = q.device_mesh, q.shape[1], k.shape[2]
    groups = q.shape[2] // hkv
    batch = [i for i, p in enumerate(q.placements) if p.is_shard(0)]
    heads = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    rows = [i for i in range(mesh.ndim)
            if i not in batch + heads and mesh.size(i) > 1]
    if sq % math.prod(mesh.size(i) for i in rows):
        rows = []
    kv_split = hkv % math.prod(mesh.size(i) for i in heads) == 0

    def placements(at: dict):
        return tuple(Shard(0) if i in batch else at.get(i, Replicate())
                     for i in range(mesh.ndim))

    qp = placements({**{i: Shard(2) for i in heads},
                     **{i: Shard(1) for i in rows}})
    kvp = placements({i: Shard(2) for i in heads if kv_split})
    # a rank reads part of a whole k / v: its gradient is a partial sum
    kv_grad = tuple(Partial() if i in rows or (i in heads and not kv_split)
                    else p for i, p in enumerate(kvp))

    def local(q, k, v):
        if heads and not kv_split:
            first = shard_index(mesh, heads) * q.shape[2]
            pick = torch.arange(first, first + q.shape[2],
                                device=q.device) // groups
            k, v = k[:, :, pick], v[:, :, pick]
        offset = q_offset + shard_index(mesh, rows) * q.shape[1]
        return core(q, k, v, q_offset=offset, **kw)

    o = local_map(local, out_placements=list(qp), in_placements=(qp, kvp, kvp),
                  in_grad_placements=(qp, kv_grad, kv_grad),
                  device_mesh=mesh)(placed(q, mesh, qp),
                                    placed(k, mesh, kvp),
                                    placed(v, mesh, kvp))
    if rows:
        o = o.redistribute(mesh, placements({i: Shard(2) for i in heads}))
    return o


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return (k[:, :, :, None, :].expand(b, s, h, groups, d)
            .reshape(b, s, h * groups, d))


def no_shard(x, kind):
    """The identity ``shard_fn``: every placement hook's default."""
    return x


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    window: int = 0, shard_fn=None) -> torch.Tensor:
    """Reference attention.

    q: (B, Sq, H, D);  k, v: (B, Skv, Hkv, D).  ``q_offset``: absolute
    position of q[0]; ``kv_len``: per-batch valid KV length; ``window``:
    sliding-window size (0 = full).  GQA contracts against the un-repeated
    K/V, as the reference does.  ``shard_fn(x, kind)`` places the score
    and probability tiles (kind ``attn_scores``); None is the identity.
    DTensor inputs run on local shards (``_attention_on_shards``), the
    hook unused: the shard is the tiles' placement.
    """
    if isinstance(q, DTensor):
        if kv_len is not None:
            raise ValueError("a DTensor attention takes no kv_len")
        return _attention_on_shards(dense_attention, q, k, v, causal=causal,
                                    q_offset=q_offset, window=window)
    sh = shard_fn or no_shard
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q5 = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k) / math.sqrt(d)
    scores = sh(scores.float(), "attn_scores")
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
    probs = sh(torch.softmax(scores, dim=-1).to(q.dtype), "attn_scores")
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return o.reshape(b, sq, h, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, q_offset: int = 0,
                      window: int = 0, kv_chunk: int = 512) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with an online softmax,
    so the (Sq, Skv) score matrix is never materialized.  Assumes
    un-padded contiguous KV.  DTensor inputs run on local shards
    (``_attention_on_shards``)."""
    if isinstance(q, DTensor):
        return _attention_on_shards(chunked_attention, q, k, v,
                                    causal=causal, q_offset=q_offset,
                                    window=window, kv_chunk=kv_chunk)
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
                     window: int = 0, shard_fn=None) -> torch.Tensor:
    """Single-step decode over a padded contiguous cache.

    q: (B, 1, H, D); caches: (B, Smax, Hkv, D); kv_len: (B,) valid
    lengths.  With ``window`` > 0 only the trailing ``window`` positions
    attend.  GQA contracts q as (B, Hkv, G, D) against the un-repeated
    cache.  ``shard_fn(x, kind)`` places the (B, Hkv, G, Skv) scores
    (kind ``dec_scores``: sequence-sharded like the cache, so the softmax
    and PV reductions combine partial results); None is the identity.
    DTensor caches run on local shards (``_decode_on_shards``)."""
    if isinstance(k_cache, DTensor):
        return _decode_on_shards(q, k_cache, v_cache, kv_len, window)
    b, _, h, d = q.shape
    _, l, o = _decode_parts(q, k_cache, v_cache, kv_len, window, 0,
                            shard_fn or no_shard)
    o = o / l[..., 0][..., None].to(q.dtype)
    return o.reshape(b, 1, h, d)


def _decode_parts(q, k_cache, v_cache, kv_len, window: int, first: int,
                  sh):
    """The softmax parts of ``decode_attention`` over cache positions
    ``first``, ``first + 1``, ...: the scores' max m, the sum l of
    exp(scores - m) and the output before division by l."""
    b, _, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    q5 = q.reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", q5, k_cache).float()
    s = sh(s / math.sqrt(d), "dec_scores")                    # (B,Hkv,G,Skv)
    k_pos = (torch.arange(skv, device=q.device) + first)[None, :]
    valid = k_pos < kv_len[:, None]
    if window > 0:
        valid = valid & (k_pos >= kv_len[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return m, l, torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype), v_cache)


def _decode_on_shards(q, k_cache, v_cache, kv_len, window: int) -> DTensor:
    """``decode_attention`` on a DTensor cache: each rank runs the plain
    parts on its own (batch, cache position) shard, the cache's own
    placement (the split of the reference's ``dec_scores`` hook), with
    every head, and the parts are merged over the ranks that split the
    positions (flash-decode: the max first, then the rescaled sums)."""
    mesh = k_cache.device_mesh
    batch = [i for i, p in enumerate(k_cache.placements) if p.is_shard(0)]
    seq = [i for i, p in enumerate(k_cache.placements) if p.is_shard(1)]
    rows = tuple(Shard(0) if i in batch else Replicate()
                 for i in range(mesh.ndim))
    cp = tuple(Shard(1) if i in seq else p for i, p in enumerate(rows))

    def local(q, k_cache, v_cache, kv_len):
        first = shard_index(mesh, seq) * k_cache.shape[1]
        m, l, o = _decode_parts(q, k_cache, v_cache, kv_len, window, first,
                                no_shard)
        for i in seq:
            top = funcol.all_reduce(m, "max", (mesh, i))
            scale = torch.exp(m - top)
            l = funcol.all_reduce(l * scale, "sum", (mesh, i))
            o = funcol.all_reduce(o * scale.to(o.dtype), "sum", (mesh, i))
            m = top
        o = o / l[..., 0][..., None].to(q.dtype)
        return o.reshape(q.shape)

    return local_map(local, out_placements=list(rows),
                     in_placements=(rows, cp, cp, rows), device_mesh=mesh)(
        placed(q, mesh, rows), placed(k_cache, mesh, cp),
        placed(v_cache, mesh, cp), placed(kv_len, mesh, rows))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    x = batch_only(x)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return pinned((F.silu(g) * u) @ p["w_down"])


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    x = batch_only(x)
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return pinned(h @ p["w_down"] + p["b_down"])


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
