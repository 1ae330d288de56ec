"""Step builders and stand-in inputs for every (architecture x input
shape) cell (port of ``repro.launch.steps``).

Shapes (assigned set):
    train_4k     seq 4096,   global batch 256   -> train_step
    prefill_32k  seq 32768,  global batch 32    -> prefill_step
    decode_32k   seq 32768,  global batch 128   -> serve_step (1 new token)
    long_500k    seq 524288, global batch 1     -> serve_step; SSM/hybrid only

No memory is allocated here: the parameter, optimizer and cache trees of
``structs`` are tensors on the ``meta`` device (the reference's
``jax.eval_shape``), in ``COMPUTE_DTYPE``.

Each ``build_*`` returns ``(step, structs, meta)``.  ``step`` takes
DTensors placed as ``step.in_shardings`` says (``param_specs`` /
``cache_specs`` / the batch specs; a plain tensor holding the same global
value on every rank is distributed on the way in) and returns DTensors
placed as ``step.out_shardings`` says: the reference's ``in_shardings`` /
``out_shardings``.  Inside, the activations are placed by ``make_shard_fn``
at the models' ``shard_fn`` hooks and DTensor's own sharding propagation
picks the collectives between them; nothing is compiled.  A ``ShapeSpec``
may stand in for a shape name, so a caller can build a step at a reduced
shape.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed.sharding import (P, NamedSharding, ShardingPolicy,
                                    cache_specs, make_shard_fn, mesh_axes,
                                    named, param_specs)
from ..models.model import (ArchConfig, decode_step, init_params, prefill,
                            resolve_device)
from ..training.optimizer import AdamWState, init_adamw
from ..training.train import make_train_step
from ..training.tree import tree_map

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

Shape = Union[str, ShapeSpec]


def _spec(shape: Shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """DESIGN.md §4 skip rules."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k-token KV is not "
                       "sub-quadratic — skipped per spec")
    return True, ""


# --------------------------------------------------------------------------
# stand-in inputs (meta tensors)
# --------------------------------------------------------------------------

def params_struct(cfg: ArchConfig) -> dict:
    return init_params(cfg, torch.Generator().manual_seed(0),
                       dtype=COMPUTE_DTYPE, device="meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_struct(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Mirror of the cache tree ``prefill`` builds (run on meta)."""
    kw = {}
    if cfg.family == "encdec":
        kw["enc_inputs"] = _sds((batch, cfg.enc_frames, cfg.d_model),
                                COMPUTE_DTYPE)
    _, cache = prefill(cfg, params_struct(cfg),
                       _sds((batch, 8), torch.int32), max_seq=max_seq, **kw)
    return cache


def input_specs(cfg: ArchConfig, shape: Shape) -> dict:
    """Meta stand-ins for every model input of this cell."""
    sp = _spec(shape)
    if sp.kind in ("train", "prefill"):
        d = {"tokens": _sds((sp.batch, sp.seq), torch.int32)}
        if sp.kind == "train":
            d["labels"] = _sds((sp.batch, sp.seq), torch.int32)
        if cfg.family == "encdec":
            d["enc_inputs"] = _sds((sp.batch, cfg.enc_frames, cfg.d_model),
                                   COMPUTE_DTYPE)
        return d
    # decode: one new token against a cache of length `seq`
    return {"tokens": _sds((sp.batch,), torch.int32),
            "cache": cache_struct(cfg, sp.batch, sp.seq)}


# --------------------------------------------------------------------------
# sharded step builders
# --------------------------------------------------------------------------

def default_microbatches(cfg: ArchConfig, policy: ShardingPolicy) -> int:
    """Grad-accum heuristic: keep the per-device microbatch at 1-2 seqs."""
    dp = policy.axis_size(policy.dp)
    per_dev = max(1, 256 // dp)
    if cfg.d_model >= 4096:
        target = 1
    elif (cfg.d_model >= 1536 or cfg.family in ("ssm", "hybrid", "encdec")):
        target = 2           # SSD chunk / encoder-attention tensors are heavy
    else:
        return 1
    return max(1, per_dev // target)


def place(tree, shardings):
    """Every tensor of ``tree`` placed by the matching ``NamedSharding``
    of ``shardings`` (a tree of the same structure)."""
    return tree_map(lambda x, s: s.place(x), tree, shardings)


def _check(policy: ShardingPolicy, device) -> None:
    """The step runs on ``device`` (the card unless the caller asks for
    the CPU), which must be the mesh's device type."""
    dev = resolve_device(device)
    mesh_type = getattr(policy.mesh, "device_type", None)
    if mesh_type is None:
        raise TypeError(f"the policy's mesh {mesh_axes(policy.mesh)} is "
                        "not a torch DeviceMesh")
    if mesh_type != dev.type:
        raise ValueError(f"the mesh is on {mesh_type!r}, the step on "
                         f"{dev.type!r}")


def _sharded(fn: Callable, in_shardings: tuple, out_shardings) -> Callable:
    """``fn`` with its inputs and outputs placed (the reference's
    ``jax.jit(fn, in_shardings=, out_shardings=)``).  The models build
    constants as plain tensors (positions, masks, rotary tables, fresh
    cache buffers), the same on every rank; ``implicit_replication``
    (an experimental DTensor API, kept here and nowhere else) lets them
    meet DTensor activations as replicated values instead of making every
    model function build them as DTensors."""
    def step(*args):
        args = tuple(a if a is None else place(a, s)
                     for a, s in zip(args, in_shardings))
        with implicit_replication():
            out = fn(*args)
        return place(out, out_shardings)

    step.in_shardings = in_shardings
    step.out_shardings = out_shardings
    return step


def build_train_step(cfg: ArchConfig, policy: ShardingPolicy,
                     microbatches: Optional[int] = None,
                     compress_grads: bool = False,
                     attn_impl: Optional[str] = None,
                     grad_rs: bool = False, *, shape: Shape = "train_4k",
                     device="cuda"):
    """``shape`` sets the batch's stand-ins (``structs[2]``); the
    microbatch count and the attention core follow ``train_4k`` as in the
    reference, whatever the shape."""
    _check(policy, device)
    mb = (default_microbatches(cfg, policy)
          if microbatches is None else microbatches)
    shard_fn = make_shard_fn(cfg, policy)
    if attn_impl is None:
        attn_impl = "chunked" if SHAPES["train_4k"].seq >= 2048 else "dense"

    mesh = policy.mesh
    p_struct = params_struct(cfg)
    p_specs = param_specs(cfg, policy, p_struct)
    grad_constraint = None
    if grad_rs:
        p_sh = named(mesh, p_specs)

        def grad_constraint(g):
            return place(g, p_sh)

    step = make_train_step(cfg, attn_impl=attn_impl, shard_fn=shard_fn,
                           remat=True, microbatches=mb,
                           compress_grads=compress_grads,
                           grad_constraint=grad_constraint)
    # as the reference's eval_shape(init_adamw, ...): no error-feedback
    # state, so ``compress_grads`` finds none to compress with
    opt_struct = init_adamw(p_struct)
    opt_specs = AdamWState(
        step=P(), mu=p_specs, nu=p_specs, master=p_specs,
        err=None if opt_struct.err is None else p_specs)
    batch_spec = {"tokens": P(policy.dp, None), "labels": P(policy.dp, None)}
    if cfg.family == "encdec":
        batch_spec["enc_inputs"] = P(policy.dp, None, None)

    in_sh = (named(mesh, p_specs), named(mesh, opt_specs),
             named(mesh, batch_spec))
    out_sh = (named(mesh, p_specs), named(mesh, opt_specs),
              {"loss": NamedSharding(mesh, P()),
               "grad_norm": NamedSharding(mesh, P())})
    structs = (p_struct, opt_struct, input_specs(cfg, shape))
    return _sharded(step, in_sh, out_sh), structs, {"microbatches": mb}


def build_prefill_step(cfg: ArchConfig, policy: ShardingPolicy,
                       shape: Shape = "prefill_32k", *, device="cuda"):
    _check(policy, device)
    sp = _spec(shape)
    shard_fn = make_shard_fn(cfg, policy)

    def fn(params, tokens, enc_inputs=None):
        kw = {"enc_inputs": enc_inputs} if enc_inputs is not None else {}
        return prefill(cfg, params, tokens, max_seq=sp.seq,
                       attn_impl="chunked", shard_fn=shard_fn, **kw)

    p_struct = params_struct(cfg)
    p_specs = param_specs(cfg, policy, p_struct)
    mesh = policy.mesh
    ins = input_specs(cfg, sp)
    in_sh = [named(mesh, p_specs), NamedSharding(mesh, P(policy.dp, None))]
    args = [p_struct, ins["tokens"]]
    if cfg.family == "encdec":
        in_sh.append(NamedSharding(mesh, P(policy.dp, None, None)))
        args.append(ins["enc_inputs"])
    c_struct = cache_struct(cfg, sp.batch, sp.seq)
    c_specs = cache_specs(cfg, policy, c_struct)
    v_ok = cfg.vocab % policy.axis_size(policy.tp) == 0
    out_sh = (NamedSharding(mesh, P(policy.dp, policy.tp if v_ok else None)),
              named(mesh, c_specs))
    return _sharded(fn, tuple(in_sh), out_sh), tuple(args), {}


def build_serve_step(cfg: ArchConfig, policy: ShardingPolicy,
                     shape: Shape = "decode_32k", *, device="cuda"):
    """One decode token.  As the port's ``decode_step``, the step writes
    the new K/V and state into the cache it is given (the reference
    donates it) and returns it with ``len`` advanced."""
    _check(policy, device)
    sp = _spec(shape)
    shard_fn = make_shard_fn(cfg, policy)

    def fn(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, shard_fn=shard_fn)

    p_struct = params_struct(cfg)
    p_specs = param_specs(cfg, policy, p_struct)
    ins = input_specs(cfg, sp)
    c_struct = ins["cache"]
    c_specs = cache_specs(cfg, policy, c_struct)
    mesh = policy.mesh
    v_ok = cfg.vocab % policy.axis_size(policy.tp) == 0
    b_ax = policy.dp_if(ins["tokens"].shape[0])
    in_sh = (named(mesh, p_specs), named(mesh, c_specs),
             NamedSharding(mesh, P(b_ax)))
    out_sh = (NamedSharding(mesh, P(b_ax, policy.tp if v_ok else None)),
              named(mesh, c_specs))
    return (_sharded(fn, in_sh, out_sh), (p_struct, c_struct, ins["tokens"]),
            {})


def build_cell(cfg: ArchConfig, shape: Shape, policy: ShardingPolicy,
               **kw):
    kind = _spec(shape).kind
    if kind == "train":
        return build_train_step(cfg, policy, shape=shape, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, policy, shape, **kw)
    return build_serve_step(cfg, policy, shape, **kw)


def parse_variant(text: Optional[str]) -> dict:
    """'mb=8,attn=dense,grad_rs=1,fsdp=0' -> build kwargs + policy tweaks."""
    out: dict = {"build": {}, "policy": {}}
    if not text:
        return out
    for kv in text.split(","):
        k, _, v = kv.partition("=")
        k, v = k.strip(), v.strip()
        if k in ("mb", "microbatches"):
            out["build"]["microbatches"] = int(v)
        elif k in ("attn", "attn_impl"):
            out["build"]["attn_impl"] = v
        elif k == "grad_rs":
            out["build"]["grad_rs"] = bool(int(v))
        elif k == "compress":
            out["build"]["compress_grads"] = bool(int(v))
        elif k == "fsdp":
            out["policy"]["fsdp"] = bool(int(v))
        elif k == "sp":
            out["policy"]["sp"] = bool(int(v))
        elif k == "seqkv":
            out["policy"]["seq_sharded_kv"] = bool(int(v))
        else:
            raise ValueError(f"unknown variant key {k}")
    return out
