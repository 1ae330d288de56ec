"""Mixture-of-Experts layer on torch tensors (port of ``repro.models.moe``):
top-k routing with per-row capacity dispatch.

The same function as the reference, written in torch idiom:

* router logits in fp32, top-k by a STABLE descending sort, so that tied
  logits keep ``lax.top_k``'s order (the lower expert index first), and
  the top-k gates softmax-normalised;
* routing slots in ``(token, k)`` order; a slot's position in its expert
  is a cumsum over the batch ROW (padding tokens count like any other),
  and slots at or past the capacity C = ceil(k S / E cf) are dropped;
* a ``(B, E, C, d)`` dispatch buffer written without accumulation (each
  kept slot owns its cell; dropped slots go to a spare cell that is cut
  off), the expert FFN as one ``bmm`` per projection batched over E,
  then the gate-weighted combine, where a dropped slot adds exact zeros,
  and the shared experts on every token.

``route`` returns the routing alone (which slots are kept), so a caller
can count the dropped slots without re-deriving the capacity rule.
No Pallas kernel computes any of this in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import no_shard


class Routing(NamedTuple):
    gates: torch.Tensor      # (B, S, k) softmax over the top-k logits
    idx: torch.Tensor        # (B, S, k) expert ids, descending logits
    pos: torch.Tensor        # (B, S*k) position of each slot in its expert
    keep: torch.Tensor       # (B, S*k) slot kept (pos < capacity)
    capacity: int


def capacity(top_k: int, s: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and batch row, the reference's float expression."""
    return max(int(math.ceil(top_k * s / n_experts * capacity_factor)), 1)


def sorted_top_k(logits: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, ties
    to the lower index (a bare ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, p: dict, top_k: int,
          capacity_factor: float = 1.25) -> Routing:
    """Router of ``moe_forward`` for x (B, S, d)."""
    b, s, _ = x.shape
    n_exp = p["router"].shape[1]
    logits = x.float() @ p["router"].float()                  # (B, S, E)
    gates, idx = sorted_top_k(logits, top_k)
    gates = torch.softmax(gates, dim=-1)
    cap = capacity(top_k, s, n_exp, capacity_factor)
    e_flat = idx.reshape(b, s * top_k)                        # (B, S*k)
    # one-hot by comparison: ``F.one_hot`` checks its range on the host,
    # a device sync in every MoE layer
    onehot = (e_flat[..., None] == torch.arange(
        n_exp, device=x.device)).to(torch.int32)             # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, 2, e_flat[..., None])[..., 0]
    return Routing(gates, idx, pos_in_e, pos_in_e < cap, cap)


def _swiglu_e(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Expert FFN batched over the expert axis: h (E, n, d) -> (E, n, d)."""
    g = torch.bmm(h, w_gate)
    u = torch.bmm(h, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def _shared(x: torch.Tensor, sp: dict) -> torch.Tensor:
    sg = x @ sp["w_gate"].to(x.dtype)
    su = x @ sp["w_up"].to(x.dtype)
    return (F.silu(sg) * su) @ sp["w_down"].to(x.dtype)


def moe_forward(x: torch.Tensor, p: dict, top_k: int,
                capacity_factor: float = 1.25,
                shard_fn=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``shard_fn(x, kind)`` places the
    (B, E, C, d) dispatch buffer (``moe_dispatch``: expert-sharded, the
    all-to-all of expert parallelism) and the experts' outputs
    (``moe_combine``); None is the identity."""
    sh = shard_fn or no_shard
    b, s, d = x.shape
    n_exp = p["router"].shape[1]
    r = route(x, p, top_k, capacity_factor)
    cap = r.capacity
    e_flat = r.idx.reshape(b, s * top_k)
    # each kept slot owns cell e * C + pos of its row; dropped slots all go
    # to the spare cell E * C, which is cut off below
    cell = torch.where(r.keep, e_flat * cap + r.pos,
                       torch.full_like(e_flat, n_exp * cap))
    x_rep = x[:, :, None, :].expand(b, s, top_k, d).reshape(b, s * top_k, d)
    buf = x.new_zeros((b, n_exp * cap + 1, d))
    rows = torch.arange(b, device=x.device)[:, None].expand_as(cell)
    buf.index_put_((rows, cell), x_rep)
    buf = sh(buf[:, :n_exp * cap].reshape(b, n_exp, cap, d), "moe_dispatch")

    # expert FFN batched over the expert axis: (E, B*C, d)
    h = buf.transpose(0, 1).reshape(n_exp, b * cap, d)
    y_e = _swiglu_e(h, p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
                    p["w_down"].to(x.dtype))
    y_e = sh(y_e.reshape(n_exp, b, cap, d).transpose(0, 1),  # (B, E, C, d)
             "moe_combine")

    # gather + gate combine: a dropped slot reads cell (e, C - 1) and is
    # zeroed, as the reference's ``where(keep, ., 0)``
    safe = torch.where(r.keep, r.pos, torch.full_like(r.pos, cap - 1))
    y_tok = y_e[rows, e_flat, safe]                          # (B, S*k, d)
    y_tok = torch.where(r.keep[..., None], y_tok, y_tok.new_zeros(()))
    y = (y_tok.reshape(b, s, top_k, d)
         * r.gates[..., None].to(x.dtype)).sum(dim=2)
    if "shared" in p:
        y = y + _shared(x, p["shared"])
    return y


def moe_ref(x: torch.Tensor, p: dict, top_k: int) -> torch.Tensor:
    """Dropless dense reference: every expert on every token, masked
    combine.  O(E) compute: only for small test configs."""
    orig = x.shape
    d = orig[-1]
    xt = x.reshape(-1, d)
    logits = xt.float() @ p["router"].float()
    gates, idx = sorted_top_k(logits, top_k)
    gates = torch.softmax(gates, dim=-1)
    g = torch.einsum("td,edf->tef", xt, p["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xt, p["w_up"].to(x.dtype))
    y_all = torch.einsum("tef,efd->ted", F.silu(g) * u,
                         p["w_down"].to(x.dtype))             # (T, E, d)
    n_exp = y_all.shape[1]
    comb = torch.zeros((xt.shape[0], n_exp), dtype=torch.float32,
                       device=x.device)
    comb.scatter_add_(1, idx, gates)
    y = torch.einsum("ted,te->td", y_all.float(), comb)
    out = y.to(x.dtype).reshape(orig)
    if "shared" in p:
        out = out + _shared(xt, p["shared"]).reshape(orig)
    return out


__all__ = ["Routing", "capacity", "sorted_top_k", "route", "moe_forward",
           "moe_ref"]
