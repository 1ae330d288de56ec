"""Mamba2 (state-space duality / SSD) block on torch tensors (port of
``repro.models.ssm``).

Per head h with scalar decay a_h = -exp(A_log_h): inputs x (B,S,H,P),
gates dt (B,S,H), shared B/C projections (B,S,N) (one group).  Two modes:

* ``ssd_chunked`` — prefill / full sequence: the sequence in chunks of
  Q; the intra-chunk term is a masked, decay-weighted quadratic product,
  the inter-chunk term carries the (H, P, N) state over the chunks in a
  Python loop (the reference's ``lax.scan``);
* ``ssd_decode_step`` — one token: the recurrent update of the
  (B, H, P, N) state.

A depthwise causal conv (width 4) precedes the SSM, computed as the
reference's shifted sum (not ``F.conv1d``, whose cuDNN path may take
TF32); its rolling inputs are carried for decode.  The SSM state and the
decay arithmetic stay in fp32 whatever the activations' dtype, as
``A_log``, ``D`` and ``dt_bias`` do in the parameter tree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from .layers import (batch_only, dense_init, evenly_split, on_batch_shards,
                     rmsnorm)

# parameter leaves kept in fp32 whatever the model dtype
FP32_LEAVES = ("A_log", "D", "dt_bias")


class SSMSpec(NamedTuple):
    d_model: int
    d_inner: int          # = expand * d_model (expand=2)
    head_dim: int         # P
    n_heads: int          # H = d_inner // P
    d_state: int          # N
    conv_width: int = 4
    chunk: int = 256


def spec_for(d_model: int, d_state: int, head_dim: int = 64,
             expand: int = 2, chunk: int = 256) -> SSMSpec:
    d_inner = expand * d_model
    return SSMSpec(d_model, d_inner, head_dim, d_inner // head_dim,
                   d_state, 4, chunk)


def init_ssm(spec: SSMSpec, generator: torch.Generator,
             dtype=torch.float32, device="cpu", lead: tuple = ()) -> dict:
    """Parameters of one SSM block in the reference's layout and scales
    (``lead`` = (L,) stacks them over the layers); ``A_log``, ``D`` and
    ``dt_bias`` in fp32 whatever ``dtype``."""
    di, H, N, W = spec.d_inner, spec.n_heads, spec.d_state, spec.conv_width
    conv_ch = di + 2 * N          # x, B, C all pass through the conv

    def normal(shape, scale):
        return dense_init(generator, lead + shape, scale, dtype, device)

    def const(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    f32 = torch.float32
    return {
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": normal((spec.d_model, 2 * di + 2 * N + H),
                       spec.d_model ** -0.5),
        "conv_w": normal((W, conv_ch), W ** -0.5),
        "conv_b": const((conv_ch,), 0.0),
        "A_log": const((H,), 0.0, f32),
        "D": const((H,), 1.0, f32),
        "dt_bias": const((H,), 0.0, f32),
        "norm_scale": const((di,), 1.0),
        "w_out": normal((di, spec.d_model), di ** -0.5),
    }


class SSMState(NamedTuple):
    ssm: torch.Tensor     # (B, H, P, N) running state, fp32
    conv: torch.Tensor    # (B, conv_width-1, conv_ch) rolling conv inputs


def init_state(spec: SSMSpec, batch: int, dtype=torch.float32,
               device="cpu") -> SSMState:
    conv_ch = spec.d_inner + 2 * spec.d_state
    return SSMState(
        ssm=torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, spec.conv_width - 1, conv_ch), dtype=dtype,
                         device=device))


def _split_proj(h: torch.Tensor, spec: SSMSpec):
    di, N = spec.d_inner, spec.d_state
    z = h[..., :di]
    xBC = h[..., di:di + di + 2 * N]
    dt = h[..., di + di + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor):
    """Depthwise causal conv along seq. xBC: (B,S,C); prev: (B,W-1,C)."""
    W, S = w.shape[0], xBC.shape[1]
    xp = torch.cat([prev.to(xBC.dtype), xBC], dim=1)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(W))
    new_prev = xp[:, -(W - 1):, :] if W > 1 else prev
    return F.silu(out + b), new_prev


def _segsum_decay(log_a: torch.Tensor) -> torch.Tensor:
    """L[i,j] = exp(sum_{j<t<=i} log_a_t) for j<=i else 0 — (…,Q,Q)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                # (…,Q,Q)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, torch.exp(diff), diff.new_zeros(()))


def _gates(params: dict, dt: torch.Tensor):
    """softplus(dt + dt_bias) and the per-head decay rate a, in fp32."""
    dt = F.softplus(dt.float() + params["dt_bias"])
    return dt, -torch.exp(params["A_log"].float())


def ssd_chunked(params: dict, spec: SSMSpec, u: torch.Tensor,
                state: SSMState | None = None,
                ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence SSD. u: (B, S, d_model) -> (B, S, d_model).  A
    DTensor ``u`` runs on each rank's batch rows (``on_batch_shards``):
    the SSD mixes nothing across rows, and its heads are not split."""
    if isinstance(u, DTensor):
        def local(params, u, ssm, conv):
            out, st = ssd_chunked(params, spec, u, None if ssm is None
                                  else SSMState(ssm, conv))
            return out, st.ssm, st.conv

        out, ssm, conv = on_batch_shards(local, 3, params, u,
                                         *(state or (None, None)))
        return out, SSMState(ssm, conv)
    B_, S, _ = u.shape
    H, P, N, Q = spec.n_heads, spec.head_dim, spec.d_state, spec.chunk
    f32 = torch.float32
    h = u @ params["w_in"].to(u.dtype)
    z, xBC, dt = _split_proj(h, spec)
    if state is None:
        state = init_state(spec, B_, dtype=u.dtype, device=u.device)
    xBC, conv_state = _causal_conv(xBC, params["conv_w"].to(u.dtype),
                                   params["conv_b"].to(u.dtype), state.conv)
    x = xBC[..., :spec.d_inner].reshape(B_, S, H, P)
    Bm = xBC[..., spec.d_inner:spec.d_inner + N]            # (B,S,N)
    Cm = xBC[..., spec.d_inner + N:]

    dt, a = _gates(params, dt)                              # (B,S,H), (H,)
    log_a = (dt * a).transpose(1, 2)                        # (B,H,S) < 0

    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        log_a = F.pad(log_a, (0, pad))
    nC = (S + pad) // Q

    xc = x.reshape(B_, nC, Q, H, P)
    Bc = Bm.reshape(B_, nC, Q, N).to(f32)
    Cc = Cm.reshape(B_, nC, Q, N).to(f32)
    dtc = dt.reshape(B_, nC, Q, H)
    lac = log_a.reshape(B_, H, nC, Q)

    # --- intra-chunk (quadratic within Q) ------------------------------
    L = _segsum_decay(lac)                                  # (B,H,nC,Q,Q)
    xdt = xc.to(f32) * dtc[..., None]                       # (B,nC,Q,H,P)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)        # (B,nC,Q,Q)
    y_intra = torch.einsum("bhcqk,bcqk,bckhp->bcqhp", L, scores, xdt)

    # --- chunk states + inter-chunk recurrence ---------------------------
    cum = torch.cumsum(lac, dim=-1)                         # (B,H,nC,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)           # (B,H,nC,Q)
    chunk_state = torch.einsum("bckn,bhck,bckhp->bchpn",
                               Bc, decay_to_end, xdt)       # (B,nC,H,P,N)
    chunk_decay = torch.exp(cum[..., -1])                   # (B,H,nC)

    s = state.ssm.to(f32)
    before = []
    for c in range(nC):
        before.append(s)                                    # state BEFORE c
        s = s * chunk_decay[:, :, c, None, None] + chunk_state[:, c]
    states_before = torch.stack(before, dim=1)              # (B,nC,H,P,N)

    decay_from_start = torch.exp(cum)                       # (B,H,nC,Q)
    y_inter = torch.einsum("bcqn,bhcq,bchpn->bcqhp",
                           Cc, decay_from_start, states_before)

    y = (y_intra + y_inter).reshape(B_, nC * Q, H, P)[:, :S]
    y = y + x[:, :S].to(f32) * params["D"][None, None, :, None]
    y = y.reshape(B_, S, spec.d_inner).to(u.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_scale"])
    out = y @ params["w_out"].to(u.dtype)
    return out, SSMState(ssm=s, conv=conv_state)


def ssd_decode_step(params: dict, spec: SSMSpec, u: torch.Tensor,
                    state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """One token. u: (B, 1, d_model)."""
    u = batch_only(u)
    B_ = u.shape[0]
    H, P, N = spec.n_heads, spec.head_dim, spec.d_state
    f32 = torch.float32
    h = u @ params["w_in"].to(u.dtype)
    z, xBC, dt = _split_proj(h, spec)
    xBC, conv_state = _causal_conv(xBC, params["conv_w"].to(u.dtype),
                                   params["conv_b"].to(u.dtype), state.conv)
    x = xBC[..., :spec.d_inner].reshape(B_, H, P)
    Bm = xBC[:, 0, spec.d_inner:spec.d_inner + N].to(f32)
    Cm = xBC[:, 0, spec.d_inner + N:].to(f32)
    dt, a = _gates(params, dt[:, 0])
    decay = torch.exp(dt * a)                               # (B,H)
    xdt = x.to(f32) * dt[..., None]                         # (B,H,P)
    new_state = (state.ssm * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xdt, Bm))
    y = torch.einsum("bhpn,bn->bhp", evenly_split(new_state), Cm)
    y = y + x.to(f32) * params["D"][None, :, None]
    y = y.reshape(B_, 1, spec.d_inner).to(u.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_scale"])
    return y @ params["w_out"].to(u.dtype), SSMState(new_state, conv_state)


__all__ = ["FP32_LEAVES", "SSMSpec", "SSMState", "spec_for", "init_ssm",
           "init_state", "ssd_chunked", "ssd_decode_step"]
