"""AdamW on trees of tensors (port of ``repro.training.optimizer``), with
optional int8 gradient compression and error feedback.

The same function as the reference, written functionally: every update
returns new tensors and leaves its inputs as they were.  The state is a
NamedTuple of dicts shaped like the parameters: ``mu`` / ``nu`` (first
and second moments), ``master`` (fp32 master copy; for fp32 parameters
the same tensors as the parameters, as nothing is updated in place) and
``err`` (the error-feedback residual, only when compressing).
``compress`` quantizes each gradient to int8 with a per-tensor scale and
dequantizes it (what the data-parallel all-reduce would carry), adding
the previous step's quantization error back first.

Arithmetic follows the reference step for step: the bias corrections
are fp32 powers of the fp32 step count (``b1 ** step.astype(f32)``) and
``quantize_int8`` rounds half to even, as ``jnp.round`` does, so on the
CPU it is bitwise the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32
    mu: dict
    nu: dict
    master: dict              # fp32 master params
    err: Optional[dict]       # error-feedback residual (compression only)


def init_adamw(params: dict, *, compress: bool = False) -> AdamWState:
    dev = leaves(params)[0].device
    # zeros_like: a DTensor parameter's moments take its placements
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        master=tree_map(lambda p: p.float(), params),
        err=tree_map(zeros, params) if compress else None)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 round trip with error feedback: returns (g_hat, new_err)."""
    g_c = g + err
    q, s = quantize_int8(g_c)
    g_hat = dequantize_int8(q, s)
    return g_hat, g_c - g_hat


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, leaves in tree order."""
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves(grads)))


def adamw_update(grads: dict, state: AdamWState, params: dict, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0,
                 compress: bool = False) -> tuple[dict, AdamWState]:
    grads = tree_map(lambda g: g.float(), grads)
    if compress and state.err is not None:
        pairs = [compress_decompress(g, e) for g, e in
                 zip(leaves(grads), leaves(state.err))]
        grads = unflatten(grads, [pair[0] for pair in pairs])
        new_err = unflatten(state.err, [pair[1] for pair in pairs])
    else:
        new_err = state.err

    # global-norm clip
    gn = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    grads = tree_map(lambda g: g * scale, grads)

    step = state.step + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, p):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / bc1, v / bc2
        p_new = p - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p)
        return m, v, p_new

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        leaves(grads), leaves(state.mu), leaves(state.nu),
        leaves(state.master))]
    mu = unflatten(state.mu, [t[0] for t in out])
    nu = unflatten(state.nu, [t[1] for t in out])
    master = unflatten(state.master, [t[2] for t in out])
    new_params = tree_map(lambda m, p: m.to(p.dtype), master, params)
    return new_params, AdamWState(step, mu, nu, master, new_err)
