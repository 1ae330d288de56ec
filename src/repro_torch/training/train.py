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

The reference's ``shard_fn`` / ``grad_constraint`` hooks (sharding of
activations and of each microbatch's gradients) are not ported: the port
trains on one card.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.model import ArchConfig, forward_train
from .optimizer import AdamWState, adamw_update, global_norm
from .tree import leaves, tree_map, unflatten


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits: (B, S, V); labels: (B, S) int -> per-token loss (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def make_loss_fn(cfg: ArchConfig, *, attn_impl: str = "dense",
                 remat: bool = True):
    def loss_fn(params, tokens, labels, enc_inputs=None):
        logits = forward_train(cfg, params, tokens, attn_impl=attn_impl,
                               remat=remat, enc_inputs=enc_inputs)
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


def make_train_step(cfg: ArchConfig, *, attn_impl: str = "dense",
                    remat: bool = True, lr: float = 3e-4,
                    grad_clip: float = 1.0, microbatches: int = 1,
                    compress_grads: bool = False):
    """Builds train_step.  ``microbatches`` > 1 splits the global batch on
    the leading axis and sums the microbatches' gradients in fp32, in
    microbatch order (the reference's ``lax.scan``), trading step latency
    for activation memory."""
    grad_fn = value_and_grad(make_loss_fn(cfg, attn_impl=attn_impl,
                                          remat=remat))

    def train_step(params, opt_state: AdamWState, batch: dict):
        tokens, labels = batch["tokens"], batch["labels"]
        enc = batch.get("enc_inputs")

        if microbatches <= 1:
            loss, grads = grad_fn(params, tokens, labels, enc)
        else:
            mb_tok = tokens.reshape(microbatches, -1, tokens.shape[-1])
            mb_lab = labels.reshape(microbatches, -1, labels.shape[-1])
            mb_enc = (enc.reshape(microbatches, -1, *enc.shape[1:])
                      if enc is not None else None)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
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
