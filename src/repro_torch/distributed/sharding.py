"""Sharding rules (port of ``repro.distributed.sharding``): map every
parameter / activation / cache tensor onto the production mesh
``("pod", "data", "model")``, as torch ``DeviceMesh`` / DTensor placements.

Strategy per mode (the reference's, rule for rule)
--------------------------------------------------
* ``train``  — FSDP x TP: weight matrices sharded over BOTH the data axis
  (ZeRO-style) and the model axis (Megatron TP); batch over pod x data;
  optional sequence-parallel residual stream (seq over "model").
* ``serve``  — TP only: weights sharded over "model", replicated across
  pod / data; request batch over pod x data; decode KV caches sharded over
  batch AND sequence (seq over "model").

Divisibility guard: a dimension is sharded only when the axis size divides
it (whisper's vocab 51865 and mamba2's 50280 are NOT divisible by 16, so
their vocab is replicated; qwen2-moe's 60 experts are not, so the experts
stay unsharded and the EXPERT-INTERNAL ffn dim is TP-sharded instead).
DTensor would accept an uneven shard; these rules never ask for one.

Specs are ``PartitionSpec`` tuples, as in JAX: one entry per tensor dim,
each ``None``, a mesh axis name, or a tuple of names (the dim split over
their product, the first name major).  ``named(mesh, specs)`` turns them
into ``NamedSharding``s, whose ``placements`` hold one DTensor placement
per mesh dim: ``Shard(d)`` where that mesh axis shards tensor dim ``d``,
``Replicate()`` otherwise (and on an axis of one rank, which splits
nothing).  A dim over ``("pod", "data")`` has
``Shard(d)`` on both mesh dims, which DTensor splits left to right:
pod-major, as JAX does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models.model import ArchConfig


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` without JAX.  A one-name tuple entry
    becomes the name and an empty one ``None``, as JAX normalises them, so
    ``tuple(spec)`` equals ``tuple(reference_spec)`` entry for entry."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a torch ``DeviceMesh`` (``mesh_dim_names``) or
    of any object with ``axis_names`` and a ``shape`` mapping (the
    reference tests' fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {n: mesh.shape[n] for n in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    mode: str = "train"            # train | serve
    sp: bool = True                # sequence-parallel residual (train)
    fsdp: bool = True              # shard params over the data axis (train)
    seq_sharded_kv: bool = True    # serve: shard KV seq over "model"

    @property
    def dp(self) -> tuple:
        return tuple(n for n in mesh_axes(self.mesh) if n in ("pod", "data"))

    @property
    def tp(self) -> str:
        return "model"

    def axis_size(self, name) -> int:
        sizes = mesh_axes(self.mesh)
        if isinstance(name, tuple):
            return math.prod(sizes[n] for n in name)
        return sizes[name]

    def dp_if(self, dim: int):
        """dp axes when the dim divides the dp extent, else None (small
        batches — e.g. long_500k's batch of 1 — replicate)."""
        return self.dp if dim % self.axis_size(self.dp) == 0 else None


def _div(dim: int, policy: ShardingPolicy, axis) -> bool:
    return dim % policy.axis_size(axis) == 0


def _matrix_spec(policy: ShardingPolicy, rows: int, cols: int,
                 col_is_tp: bool) -> P:
    """Spec for a (rows, cols) weight: TP on one dim, FSDP on the other."""
    tp, dpa = policy.tp, "data"
    tp_dim_ok = _div(cols if col_is_tp else rows, policy, tp)
    if policy.mode == "serve" or not policy.fsdp:
        fs = None
    else:
        fs_dim = rows if col_is_tp else cols
        fs = dpa if _div(fs_dim, policy, dpa) else None
    if col_is_tp:
        return P(fs, tp) if tp_dim_ok else P(fs, None)
    return P(tp, fs) if tp_dim_ok else P(None, fs)


def param_specs(cfg: ArchConfig, policy: ShardingPolicy, params: dict):
    """Spec tree mirroring ``init_params``' tree (leaves need ``shape``
    only).  Layer parameters carry a LEADING layer axis: their specs gain
    a ``None`` in front."""

    def _leaf_spec(names, shape) -> P:
        n = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        # --- embeddings / unembedding: (V, d) ---
        if n in ("embed", "lm_head"):
            v_ok = _div(shape[0], policy, policy.tp)
            if policy.mode == "serve" or not policy.fsdp:
                return P(policy.tp if v_ok else None, None)
            d_ok = _div(shape[1], policy, "data")
            return P(policy.tp if v_ok else None, "data" if d_ok else None)
        # --- norms / scalars / small vectors: replicate ---
        if n in ("scale", "bias", "q_norm", "k_norm", "A_log", "D",
                 "dt_bias", "norm_scale", "conv_b"):
            return P(*([None] * len(shape)))
        # --- attention projections ---
        if n in ("wq", "wk", "wv"):
            return _matrix_spec(policy, shape[0], shape[1], col_is_tp=True)
        if n == "wo":
            return _matrix_spec(policy, shape[0], shape[1], col_is_tp=False)
        if n in ("bq", "bk", "bv"):
            return P(policy.tp if _div(shape[0], policy, policy.tp) else None)
        # --- dense MLP ---
        if n in ("w_gate", "w_up") and parent != "moe" and len(shape) == 2:
            return _matrix_spec(policy, shape[0], shape[1], col_is_tp=True)
        if n == "w_down" and len(shape) == 2:
            return _matrix_spec(policy, shape[0], shape[1], col_is_tp=False)
        if n in ("b_up",):
            return P(policy.tp if _div(shape[0], policy, policy.tp) else None)
        if n in ("b_down",):
            return P(None)
        # --- MoE experts: (E, d, f) / (E, f, d) ---
        if len(shape) == 3:
            E = shape[0]
            if _div(E, policy, policy.tp):          # expert parallelism
                return P(policy.tp, None, None)
            # TP-within-expert fallback (e.g. qwen2-moe's 60 experts)
            if n in ("w_gate", "w_up") and _div(shape[2], policy, policy.tp):
                return P(None, None, policy.tp)
            if n == "w_down" and _div(shape[1], policy, policy.tp):
                return P(None, policy.tp, None)
            return P(None, None, None)
        if n == "router":
            return P(None, None)
        # --- SSM ---
        if n == "w_in":
            fs = "data" if (policy.mode == "train" and policy.fsdp
                            and _div(shape[0], policy, "data")) else None
            return P(fs, None)
        if n == "w_out":
            fs = "data" if (policy.mode == "train" and policy.fsdp
                            and _div(shape[1], policy, "data")) else None
            return P(None, fs)
        if n == "conv_w":
            return P(None, None)
        return P(*([None] * len(shape)))

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, names + (k,)) for k, v in node.items()}
        stacked = "layers" in names[0]
        shape = tuple(node.shape)
        s = _leaf_spec(names, shape[1:] if stacked else shape)
        return P(None, *s) if stacked else s

    return visit(params, ())


# --------------------------------------------------------------------------
# activation sharding callback
# --------------------------------------------------------------------------

def make_shard_fn(cfg: ArchConfig, policy: ShardingPolicy) -> Callable:
    """Returns ``shard_fn(x, kind)``: a DTensor is redistributed to the
    placements of ``kind``'s spec (the reference's
    ``with_sharding_constraint``: the value is unchanged, only where it
    lives); a plain tensor, or a kind with no spec, comes back as it is.
    ``shard_fn.spec_of(kind, x)`` is the spec (None: no constraint)."""
    tp = policy.tp

    def spec_of(kind: str, x) -> Optional[P]:
        if kind == "act":                      # (B, S, d) residual stream
            # sequence-parallel residual in BOTH modes: bounds per-layer
            # activation footprint (train remat carries, 32k prefill temps)
            b = policy.dp_if(x.shape[0])
            if policy.sp and x.shape[1] % policy.axis_size(tp) == 0:
                return P(b, tp, None)
            return P(b, None, None)
        if kind == "logits":                   # (B, S, V)
            v_ok = x.shape[-1] % policy.axis_size(tp) == 0
            return P(policy.dp_if(x.shape[0]), None, tp if v_ok else None)
        if kind == "act_decode":               # (B, 1, d)
            return P(policy.dp_if(x.shape[0]), None, None)
        if kind == "logits_decode":            # (B, V)
            v_ok = x.shape[-1] % policy.axis_size(tp) == 0
            return P(policy.dp_if(x.shape[0]), tp if v_ok else None)
        if kind in ("moe_dispatch", "moe_combine"):   # (B, E, C, d)
            e_ok = x.shape[1] % policy.axis_size(tp) == 0
            # EP when E divides the axis — this redistribution IS the
            # all-to-all
            return P(policy.dp_if(x.shape[0]), tp if e_ok else None,
                     None, None)
        if kind == "kv_stack":                 # per-layer (B, S, Hkv, hd)
            s_ok = (policy.seq_sharded_kv
                    and x.shape[1] % policy.axis_size(tp) == 0)
            return P(policy.dp_if(x.shape[0]), tp if s_ok else None,
                     None, None)
        if kind == "attn_scores":          # (B, Hkv, G, Sq, Skv)
            q_ok = x.shape[3] % policy.axis_size(tp) == 0
            return P(policy.dp_if(x.shape[0]), None, None,
                     tp if q_ok else None, None)
        if kind == "dec_scores":               # (B, Hkv, G, Skv)
            s_ok = x.shape[-1] % policy.axis_size(tp) == 0
            return P(policy.dp_if(x.shape[0]), None, None,
                     tp if s_ok else None)
        return None

    def shard_fn(x, kind: str):
        if not isinstance(x, DTensor):
            return x
        s = spec_of(kind, x)
        if s is None:
            return x
        return x.redistribute(x.device_mesh,
                              placements_of(x.device_mesh, s))

    shard_fn.spec_of = spec_of
    return shard_fn


def cache_specs(cfg: ArchConfig, policy: ShardingPolicy, cache: dict):
    """Specs for the serving cache tree.

    KV: (L, B, S, Hkv, hd) — batch over pod x data; seq over "model" when
    enabled (flash-decode combine; works for ANY kv_heads count including
    chatglm3's kv=2).  SSM state: (L, B, H, P, N) — batch over pod x data,
    heads over "model" when divisible.
    """
    tp = policy.tp
    specs = {}
    for k, v in cache.items():
        if k == "len":
            specs[k] = P(policy.dp_if(v.shape[0]))
        elif k in ("k", "v", "cross_k", "cross_v"):
            b = policy.dp_if(v.shape[1])
            seq_ok = (policy.seq_sharded_kv
                      and v.shape[2] % policy.axis_size(tp) == 0)
            specs[k] = P(None, b, tp if seq_ok else None, None, None)
        elif k == "ssm":
            b = policy.dp_if(v.shape[1])
            h_ok = v.shape[2] % policy.axis_size(tp) == 0
            specs[k] = P(None, b, tp if h_ok else None, None, None)
        elif k == "conv":
            specs[k] = P(None, policy.dp_if(v.shape[1]), None, None)
        else:
            specs[k] = P(*([None] * v.ndim))
    return specs


# --------------------------------------------------------------------------
# specs -> DTensor placements
# --------------------------------------------------------------------------

def placements_of(mesh, spec: P) -> tuple:
    """One placement per mesh dim for ``spec``: ``Shard(d)`` where the
    mesh axis shards tensor dim ``d``, else ``Replicate()``.  An axis of
    one rank splits nothing: it takes ``Replicate()``, the same layout
    (JAX calls such an array fully replicated along it), and the one
    that torch 2.11's DTensor can flatten in a view (its view ops refuse
    to merge dims when a Shard dim is not the first of them, even over a
    single rank)."""
    sizes = mesh_axes(mesh)
    names = tuple(sizes)
    dim_of: dict = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        if not set(group) <= set(names):
            raise ValueError(f"{spec}: axes {group} are not all in the "
                             f"mesh {names}")
        if list(group) != sorted(group, key=names.index):
            raise ValueError(f"{spec}: axes {group} are not in the mesh's "
                             f"(major-first) order {names}")
        for name in group:
            if name in dim_of:
                raise ValueError(f"{spec}: mesh axis {name!r} shards two "
                                 "dims")
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of and sizes[n] > 1
                 else Replicate() for n in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec on a mesh."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)

    def place(self, x: torch.Tensor) -> DTensor:
        """``x`` as a DTensor with these placements: a DTensor is
        redistributed; a plain tensor (the same global value on every
        rank) is split with ``distribute_tensor``, each rank keeping its
        shard alone."""
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_tensor(x, self.mesh, self.placements)


def map_specs(fn: Callable, tree):
    """``fn`` on each spec of a tree of dicts, NamedTuples, tuples / lists
    and ``None`` (an empty subtree) whose leaves are ``PartitionSpec``s."""
    if tree is None or isinstance(tree, PartitionSpec):
        return None if tree is None else fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def named(mesh, spec_tree):
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)
