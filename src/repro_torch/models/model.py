"""Config-driven model assembly on torch tensors (port of
``repro.models.model``, dense family).

``ArchConfig`` is a field-for-field copy of the reference dataclass, so the
twelve config files under ``repro_torch/configs`` are the same data.
Parameters are a plain nested dict of tensors in the reference's layout:
layer parameters STACKED on a leading axis, ``wq`` as (d, H*hd) and
``lm_head`` as (V, d).  Where JAX scans over the stacked layers, the port
loops over them in Python (``layer_params`` indexes one layer as views).

Public entry points:
  * ``init_params(cfg, generator, ...)``  random parameters from a seed
  * ``forward(cfg, params, tokens, ...)`` full-sequence logits

Only ``family == "dense"`` is ported; other families raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .layers import apply_norm, apply_rope, dense_attention, gelu_mlp, \
    rmsnorm, swiglu


class SSMSpec(NamedTuple):
    """Copy of ``repro.models.ssm.SSMSpec`` (config data only)."""
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


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 1e4
    window: int = 0              # sliding-window size (hybrid)
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_frames: int = 0          # stub-frontend sequence length
    # --- misc ---
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4 skip rule)."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_spec(self) -> SSMSpec:
        return spec_for(self.d_model, self.ssm_state,
                        head_dim=self.ssm_head_dim, chunk=self.ssm_chunk)

    def param_count(self) -> float:
        """Analytic total parameter count."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.family == "moe":
            ff = self.n_experts * 3 * d * self.d_expert \
                + (3 * d * self.n_shared * self.d_expert) + d * self.n_experts
        elif self.family == "ssm":
            attn = 0
            ff = 0
        else:
            ff = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            sp = self.ssm_spec
            ssm = d * (2 * sp.d_inner + 2 * sp.d_state + sp.n_heads) \
                + sp.d_inner * d
        per_layer = attn + ff + ssm
        total = self.n_layers * per_layer + 2 * self.vocab * d
        if self.family == "encdec":
            enc_ff = 2 * d * self.d_ff
            total += self.n_enc_layers * (attn + enc_ff) \
                + self.n_layers * attn        # cross attention
        return float(total)

    def active_param_count(self) -> float:
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_part = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * self.d_expert)
        return dense_part + self.n_layers * (
            self.top_k * 3 * d * self.d_expert)


def require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch ports the dense family only; {cfg.name!r} is "
            f"{cfg.family!r}")


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; a CUDA device with no card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> dict:
    """Random parameters in the reference's tree layout (layers stacked on
    axis 0).  Matrices are N(0, 1) * scale with the reference's scales
    (``dense_init``: 1/sqrt(fan_in); embeddings 0.02; ``wo``
    1/sqrt(2 H hd L)); biases start at 0 and norm scales at 1.  torch and
    jax.random draw different numbers from one seed: tests that compare
    with the JAX package build parameters there and convert them with
    ``convert.params_from_numpy``."""
    require_dense(cfg)
    dev = resolve_device(device)
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers

    def normal(shape, scale=None):
        scale = 1.0 / math.sqrt(shape[-2]) if scale is None else scale
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev) * scale
        return t.to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def norm(lead=()):
        p = {"scale": const(lead + (d,), 1.0)}
        if cfg.norm == "layernorm":
            p["bias"] = const(lead + (d,), 0.0)
        return p

    attn = {
        "wq": normal((L, d, cfg.n_heads * hd)),
        "wk": normal((L, d, cfg.n_kv_heads * hd)),
        "wv": normal((L, d, cfg.n_kv_heads * hd)),
        "wo": normal((L, cfg.n_heads * hd, d),
                     scale=1.0 / math.sqrt(cfg.n_heads * hd * 2 * L)),
    }
    if cfg.qkv_bias:
        attn["bq"] = const((L, cfg.n_heads * hd), 0.0)
        attn["bk"] = const((L, cfg.n_kv_heads * hd), 0.0)
        attn["bv"] = const((L, cfg.n_kv_heads * hd), 0.0)
    if cfg.qk_norm:
        attn["q_norm"] = const((L, hd), 1.0)
        attn["k_norm"] = const((L, hd), 1.0)
    if cfg.act == "gelu":
        mlp = {"w_up": normal((L, d, cfg.d_ff)),
               "b_up": const((L, cfg.d_ff), 0.0),
               "w_down": normal((L, cfg.d_ff, d)),
               "b_down": const((L, d), 0.0)}
    else:
        mlp = {"w_gate": normal((L, d, cfg.d_ff)),
               "w_up": normal((L, d, cfg.d_ff)),
               "w_down": normal((L, cfg.d_ff, d))}
    return {
        "embed": normal((cfg.vocab, d), scale=0.02),
        "lm_head": normal((cfg.vocab, d), scale=0.02),
        "ln_f": norm(),
        "layers": {"ln1": norm((L,)), "ln2": norm((L,)), "attn": attn,
                   "mlp": mlp},
    }


def layer_params(tree: dict, li: int) -> dict:
    """Layer ``li`` of the stacked layer tree, as views."""
    return {k: layer_params(v, li) if isinstance(v, dict) else v[li]
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# attention sub-block (full sequence)
# --------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, ap: dict, x: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ ap["wq"]
    k = x @ ap["wk"]
    v = x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, ap["q_norm"])
        k = rmsnorm(k, ap["k_norm"])
    return q, k, v


def _attn_block(cfg: ArchConfig, ap: dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool):
    """Returns (out, k, v) — k/v pre-repeat, post-rope."""
    q, k, v = _qkv(cfg, ap, x)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    o = dense_attention(q, k, v, causal=causal, window=cfg.window)
    b, s = x.shape[:2]
    out = o.reshape(b, s, -1) @ ap["wo"]
    return out, k, v


def _mlp(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, lp["mlp"]) if cfg.act == "swiglu" \
        else gelu_mlp(h, lp["mlp"])


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------

@torch.no_grad()
def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            last_only: bool = False) -> torch.Tensor:
    """Token logits (B, S, V) for a full sequence (``last_only``: (B, 1, V)
    for the final position only).  The reference also returns a serving
    cache; the port's serving path builds its cache in the paged pool, so
    only the logits are returned."""
    require_dense(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :]
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        mix, _, _ = _attn_block(cfg, lp["attn"], h, positions, causal=True)
        x = x + mix
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + _mlp(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    if last_only:
        x = x[:, -1:]
    return x @ params["lm_head"].T


def greedy_generate(cfg: ArchConfig, params: dict, prompt,
                    n: int) -> list[int]:
    """Teacher-forced greedy reference: ``n`` tokens, each the argmax of a
    full-sequence ``forward`` over prompt + tokens so far."""
    dev = params["embed"].device
    cur = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None, :]
    out: list[int] = []
    for _ in range(n):
        nxt = int(forward(cfg, params, cur, last_only=True)[0, -1].argmax())
        out.append(nxt)
        cur = torch.cat([cur, cur.new_tensor([[nxt]])], dim=1)
    return out


__all__ = ["ArchConfig", "SSMSpec", "spec_for", "init_params", "forward",
           "greedy_generate", "layer_params", "resolve_device",
           "require_dense"]
