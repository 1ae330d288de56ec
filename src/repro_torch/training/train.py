"""Training step: cross-entropy + AdamW + grad-accum microbatching (port
of ``repro.training.train``).

``make_train_step`` returns a function

    (params, opt_state, batch{tokens, labels[, enc_inputs]})
        -> (params, opt_state, metrics{loss, grad_norm})

that leaves its inputs as they were.  Gradients come from plain PyTorch
autograd through ``models.model.forward_train``: the reference has no
custom VJP and no backward kernel, and its loss runs the dense or
chunked attention (plain JAX), so no CUDA kernel of the port lies on
this path.  ``value_and_grad`` is the counterpart of
``jax.value_and_grad`` over a tree of tensors.

The reference's hooks are kept: ``shard_fn`` places activations (see
``models.model.forward_train``) and ``grad_constraint`` places each
microbatch's gradients.  Both are None (the identity) on one device;
``launch.steps.build_train_step`` passes them for DTensor parameters.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ..models.layers import placed, shard_index
from ..models.model import ArchConfig, forward_train
from .optimizer import AdamWState, adamw_update, global_norm
from .tree import leaves, tree_map, unflatten


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits: (B, S, V); labels: (B, S) int -> per-token loss (B, S).
    DTensor logits stay in their vocab placement
    (``_sharded_cross_entropy``)."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def _sharded_cross_entropy(logits: DTensor, labels) -> DTensor:
    """The cross-entropy of vocab-sharded logits, never gathered: each
    rank takes its vocab shard's logsumexp and its label pick (zero when
    the label lies in another shard) through ``local_map``, as one
    column each of a (B, S, shards) pair, and a logsumexp and a sum over
    those columns combine them.  The columns are split like the vocab,
    so their gradients come back as each rank's own."""
    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(2)]
    lp = tuple(p if p.is_shard(0) or p.is_shard(1) or i in vocab
               else Replicate() for i, p in enumerate(logits.placements))
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(lp))

    def local(logits, labels):
        logits = logits.float()
        n = logits.shape[-1]
        idx = labels.long()[..., None] - shard_index(mesh, vocab) * n
        inside = (idx >= 0) & (idx < n)
        gold = torch.gather(logits, -1, idx.clamp(0, n - 1))
        return (torch.logsumexp(logits, dim=-1, keepdim=True),
                torch.where(inside, gold, gold.new_zeros(())))

    lse, gold = local_map(local, out_placements=(list(lp), list(lp)),
                          in_placements=(lp, rows), device_mesh=mesh)(
        placed(logits, mesh, lp), placed(labels, mesh, rows))
    return torch.logsumexp(lse, dim=-1) - gold.sum(-1)


def make_loss_fn(cfg: ArchConfig, *, attn_impl: str = "dense",
                 shard_fn: Optional[Callable] = None, remat: bool = True):
    def loss_fn(params, tokens, labels, enc_inputs=None):
        logits = forward_train(cfg, params, tokens, attn_impl=attn_impl,
                               remat=remat, enc_inputs=enc_inputs,
                               shard_fn=shard_fn)
        return softmax_cross_entropy(logits, labels).mean()
    return loss_fn


def value_and_grad(loss_fn: Callable):
    """``jax.value_and_grad(loss_fn)``: (params, *args) -> (loss, grads),
    the loss detached and ``grads`` a tree like ``params`` (zeros for a
    leaf the loss does not read).  The parameters are not modified."""
    def fn(params, *args):
        with torch.enable_grad():
            tracked = [t.detach().requires_grad_(True)
                       for t in leaves(params)]
            loss = loss_fn(unflatten(params, tracked), *args)
            grads = torch.autograd.grad(loss, tracked, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(tracked, grads)]
        return loss.detach(), unflatten(params, grads)
    return fn


def microbatch_loop(n: int):
    """The microbatch indices ``train_step`` runs, in order.  The cost
    model traces the first two, the second weighted by ``n - 1``
    (``launch.hlo_cost.one_microbatch``)."""
    return range(n)


def split_microbatches(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, ...) as (n, B / n, ...).  Microbatch i is rows
    [i B / n, (i + 1) B / n), as in the reference, unless ``x`` is a
    DTensor whose leading dim is split over dp ranks and dp does not
    divide n: DTensor cannot reshape that, so there microbatch i is each
    rank's i-th block of its own rows.  No row moves, and the gradient
    is the same sum in another order."""
    dp = 1
    if isinstance(x, DTensor):
        dp = math.prod(x.device_mesh.size(i)
                       for i, p in enumerate(x.placements) if p.is_shard(0))
    if n % dp == 0:
        return x.reshape(n, -1, *x.shape[1:])
    b = x.shape[0] // (dp * n)
    return (x.reshape(dp, n, b, *x.shape[1:]).transpose(0, 1)
            .reshape(n, dp * b, *x.shape[1:]))


def make_train_step(cfg: ArchConfig, *, attn_impl: str = "dense",
                    shard_fn: Optional[Callable] = None, remat: bool = True,
                    lr: float = 3e-4, grad_clip: float = 1.0,
                    microbatches: int = 1, compress_grads: bool = False,
                    grad_constraint: Optional[Callable] = None):
    """Builds train_step.  ``microbatches`` > 1 splits the global batch on
    the leading axis and sums the microbatches' gradients in fp32, in
    microbatch order (the reference's ``lax.scan``), trading step latency
    for activation memory.

    ``grad_constraint``: optional callback on each microbatch's gradient
    tree (pinning DTensor gradients to the parameters' placements turns
    their all-reduce into a reduce-scatter: ZeRO gradient sharding)."""
    raw_grad = value_and_grad(make_loss_fn(cfg, attn_impl=attn_impl,
                                           shard_fn=shard_fn, remat=remat))

    def grad_fn(params, tokens, labels, enc=None):
        loss, g = raw_grad(params, tokens, labels, enc)
        if grad_constraint is not None:
            g = grad_constraint(g)
        return loss, g

    def train_step(params, opt_state: AdamWState, batch: dict):
        tokens, labels = batch["tokens"], batch["labels"]
        enc = batch.get("enc_inputs")

        if microbatches <= 1:
            loss, grads = grad_fn(params, tokens, labels, enc)
        else:
            mb_tok = split_microbatches(tokens, microbatches)
            mb_lab = split_microbatches(labels, microbatches)
            mb_enc = (split_microbatches(enc, microbatches)
                      if enc is not None else None)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in microbatch_loop(microbatches):
                l_i, g_i = grad_fn(params, mb_tok[i], mb_lab[i],
                                   None if mb_enc is None else mb_enc[i])
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)

        new_params, new_opt = adamw_update(
            grads, opt_state, params, lr=lr, grad_clip=grad_clip,
            compress=compress_grads)
        gn = global_norm(tree_map(lambda g: g.float(), grads))
        return new_params, new_opt, {"loss": loss, "grad_norm": gn}

    return train_step


__all__ = ["softmax_cross_entropy", "make_loss_fn", "value_and_grad",
           "make_train_step"]
