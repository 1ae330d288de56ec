"""Config-driven model assembly on torch tensors (port of
``repro.models.model``): every family of the reference (dense / moe /
ssm / hybrid / encdec).

``ArchConfig`` is a field-for-field copy of the reference dataclass, so the
twelve config files under ``repro_torch/configs`` are the same data.
Parameters are a plain nested dict of tensors in the reference's layout:
layer parameters STACKED on a leading axis, ``wq`` as (d, H*hd) and
``lm_head`` as (V, d).  Where JAX scans over the stacked layers, the port
loops over them in Python (``layer_params`` indexes one layer as views).

Public entry points:
  * ``init_params(cfg, generator, ...)``  random parameters from a seed
  * ``forward(cfg, params, tokens, ...)`` full-sequence logits (and, with
    ``collect_cache``, a serving cache)
  * ``prefill(cfg, params, tokens, max_seq, ...)`` build a serving cache
  * ``decode_step(cfg, params, cache, tok)``  one token with cache
  * encoder-decoder variants take ``enc_inputs`` (stub frontend
    embeddings).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import kvcache, moe
from .layers import (apply_norm, apply_rope, chunked_attention,
                     decode_attention, dense_attention, dense_init, gelu_mlp,
                     rmsnorm, sinusoidal_positions, swiglu)
from .ssm import (SSMSpec, SSMState, init_ssm, spec_for, ssd_chunked,
                  ssd_decode_step)


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
    (``dense_init``: 1/sqrt of the unstacked leaf's first axis, so
    1/sqrt(E) for the (E, d, f) expert stacks; embeddings 0.02; ``wo``
    1/sqrt(2 H hd L)); biases start at 0 and norm scales at 1; the SSM's
    ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever ``dtype``.  torch
    and jax.random draw different numbers from one seed: tests that
    compare with the JAX package build parameters there and convert them
    with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.hd

    def normal(shape, scale=None):
        scale = 1.0 / math.sqrt(shape[-2]) if scale is None else scale
        return dense_init(generator, shape, scale, dtype, dev)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def norm(lead=()):
        p = {"scale": const(lead + (d,), 1.0)}
        if cfg.norm == "layernorm":
            p["bias"] = const(lead + (d,), 0.0)
        return p

    def attn(L):
        p = {
            "wq": normal((L, d, cfg.n_heads * hd)),
            "wk": normal((L, d, cfg.n_kv_heads * hd)),
            "wv": normal((L, d, cfg.n_kv_heads * hd)),
            "wo": normal((L, cfg.n_heads * hd, d),
                         scale=1.0 / math.sqrt(cfg.n_heads * hd * 2 * L)),
        }
        if cfg.qkv_bias:
            p["bq"] = const((L, cfg.n_heads * hd), 0.0)
            p["bk"] = const((L, cfg.n_kv_heads * hd), 0.0)
            p["bv"] = const((L, cfg.n_kv_heads * hd), 0.0)
        if cfg.qk_norm:
            p["q_norm"] = const((L, hd), 1.0)
            p["k_norm"] = const((L, hd), 1.0)
        return p

    def mlp(L):
        if cfg.act == "gelu":
            return {"w_up": normal((L, d, cfg.d_ff)),
                    "b_up": const((L, cfg.d_ff), 0.0),
                    "w_down": normal((L, cfg.d_ff, d)),
                    "b_down": const((L, d), 0.0)}
        return {"w_gate": normal((L, d, cfg.d_ff)),
                "w_up": normal((L, d, cfg.d_ff)),
                "w_down": normal((L, cfg.d_ff, d))}

    def moe_block(L):
        E, f = cfg.n_experts, cfg.d_expert
        p = {"router": normal((L, d, E)),
             "w_gate": normal((L, E, d, f), scale=E ** -0.5),
             "w_up": normal((L, E, d, f), scale=E ** -0.5),
             "w_down": normal((L, E, f, d), scale=E ** -0.5)}
        if cfg.n_shared:
            fs = cfg.n_shared * f
            p["shared"] = {"w_gate": normal((L, d, fs)),
                           "w_up": normal((L, d, fs)),
                           "w_down": normal((L, fs, d))}
        return p

    def layers(L):
        p = {"ln1": norm((L,)), "ln2": norm((L,))}
        if cfg.family != "ssm":
            p["attn"] = attn(L)
        if cfg.family == "moe":
            p["moe"] = moe_block(L)
        elif cfg.family == "ssm":
            p["ssm"] = init_ssm(cfg.ssm_spec, generator, dtype, dev, (L,))
        else:
            p["mlp"] = mlp(L)
        if cfg.family == "hybrid":
            p["ssm"] = init_ssm(cfg.ssm_spec, generator, dtype, dev, (L,))
            p["attn_out_norm"] = {"scale": const((L, d), 1.0)}
            p["ssm_out_norm"] = {"scale": const((L, d), 1.0)}
        return p

    if cfg.family == "encdec":
        L, Le = cfg.n_layers, cfg.n_enc_layers
        tree = {"enc_layers": {"ln1": norm((Le,)), "ln2": norm((Le,)),
                               "attn": attn(Le), "mlp": mlp(Le)},
                "enc_ln_f": norm(),
                "layers": {"ln1": norm((L,)), "attn": attn(L),
                           "ln_x": norm((L,)), "xattn": attn(L),
                           "ln2": norm((L,)), "mlp": mlp(L)}}
    else:
        tree = {"layers": layers(cfg.n_layers)}
    return {
        "embed": normal((cfg.vocab, d), scale=0.02),
        "lm_head": normal((cfg.vocab, d), scale=0.02),
        "ln_f": norm(),
        **tree,
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


def _attend(q, k, v, *, causal: bool, attn_impl: str, window: int = 0):
    if attn_impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window)
    return dense_attention(q, k, v, causal=causal, window=window)


def _attn_block(cfg: ArchConfig, ap: dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool,
                attn_impl: str = "dense"):
    """Returns (out, k, v) — k/v pre-repeat, post-rope, for cache storage."""
    q, k, v = _qkv(cfg, ap, x)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    o = _attend(q, k, v, causal=causal, attn_impl=attn_impl,
                window=cfg.window)
    b, s = x.shape[:2]
    out = o.reshape(b, s, -1) @ ap["wo"]
    return out, k, v


def _mlp(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, lp["mlp"]) if cfg.act == "swiglu" \
        else gelu_mlp(h, lp["mlp"])


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward: routed experts (moe) or the dense MLP."""
    if cfg.family == "moe":
        return moe.moe_forward(h, lp["moe"], cfg.top_k, cfg.capacity_factor)
    return _mlp(cfg, lp, h)


def _hybrid_mix(lp: dict, a_out: torch.Tensor, s_out: torch.Tensor):
    return 0.5 * (rmsnorm(a_out, lp["attn_out_norm"]["scale"])
                  + rmsnorm(s_out, lp["ssm_out_norm"]["scale"]))


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------

@torch.no_grad()
def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            attn_impl: str = "dense",
            enc_inputs: Optional[torch.Tensor] = None,
            collect_cache: bool = False, last_only: bool = False,
            max_seq: int = 0):
    """Token logits (B, S, V) for a full sequence (``last_only``: (B, 1, V)
    for the final position only).  ``collect_cache`` returns (logits,
    serving cache of ``max_seq`` positions) instead, as the reference's
    ``forward`` does; without it only the logits come back (the serving
    engine keeps its cache in the paged pool)."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :]

    if cfg.family == "encdec":
        enc_out = _encoder(cfg, params, enc_inputs, attn_impl)
        logits, cache = _decoder_encdec(cfg, params, x, positions, enc_out,
                                        attn_impl, collect_cache, max_seq,
                                        last_only)
        return (logits, cache) if collect_cache else logits

    spec = cfg.ssm_spec if cfg.family in ("ssm", "hybrid") else None
    extras: dict[str, list] = {"k": [], "v": [], "ssm": [], "conv": []}
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        st = k = v = None
        if cfg.family == "ssm":
            mix, st = ssd_chunked(lp["ssm"], spec, h)
        elif cfg.family == "hybrid":
            a_out, k, v = _attn_block(cfg, lp["attn"], h, positions,
                                      causal=True, attn_impl=attn_impl)
            s_out, st = ssd_chunked(lp["ssm"], spec, h)
            mix = _hybrid_mix(lp, a_out, s_out)
        else:
            mix, k, v = _attn_block(cfg, lp["attn"], h, positions,
                                    causal=True, attn_impl=attn_impl)
        x = x + mix
        if cfg.family != "ssm":
            h2 = apply_norm(x, lp["ln2"], cfg.norm)
            x = x + _ffn(cfg, lp, h2)
        if collect_cache:
            if k is not None:
                extras["k"].append(k)
                extras["v"].append(v)
            if st is not None:
                extras["ssm"].append(st.ssm)
                extras["conv"].append(st.conv)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    if last_only:
        x = x[:, -1:]
    logits = x @ params["lm_head"].T
    if not collect_cache:
        return logits
    stacked = {key: torch.stack(vals) for key, vals in extras.items()
               if vals}
    return logits, _build_cache(cfg, stacked, b, s, max_seq or s)


def _build_cache(cfg: ArchConfig, extras: dict, b: int, s: int,
                 max_seq: int) -> dict:
    dev = next(iter(extras.values())).device
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=dev)}
    if "k" in extras:
        k, v = extras["k"], extras["v"]              # (L,B,S,Hkv,hd)
        if cfg.window > 0:
            w = cfg.window
            kc = k.new_zeros((k.shape[0], b, w, cfg.n_kv_heads, cfg.hd))
            vc = torch.zeros_like(kc)
            # write the trailing `window` positions into ring slots
            pos = torch.arange(max(s - w, 0), s, device=dev)
            slot = pos % w
            kc[:, :, slot] = k[:, :, pos]
            vc[:, :, slot] = v[:, :, pos]
            cache["k"], cache["v"] = kc, vc
        else:
            pad = max_seq - s
            if pad < 0:
                raise ValueError(f"max_seq {max_seq} < prompt length {s}")
            cache["k"] = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            cache["v"] = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    if "ssm" in extras:
        cache["ssm"], cache["conv"] = extras["ssm"], extras["conv"]
    return cache


# --------------------------------------------------------------------------
# encoder-decoder (whisper-style; frontend = stub embeddings)
# --------------------------------------------------------------------------

def _encoder(cfg: ArchConfig, params: dict, enc_inputs: torch.Tensor,
             attn_impl: str) -> torch.Tensor:
    if enc_inputs is None:
        raise ValueError(f"{cfg.name!r} is an encoder-decoder: pass "
                         "enc_inputs (B, frames, d_model)")
    n_frames = enc_inputs.shape[1]
    x = enc_inputs + sinusoidal_positions(
        n_frames, cfg.d_model, enc_inputs.dtype, enc_inputs.device)[None]
    positions = torch.arange(n_frames, device=x.device)[None, :]
    enc_cfg = dataclasses.replace(cfg, family="dense", rope_fraction=0.0)
    for li in range(cfg.n_enc_layers):
        lp = layer_params(params["enc_layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        mix, _, _ = _attn_block(enc_cfg, lp["attn"], h, positions,
                                causal=False, attn_impl=attn_impl)
        x = x + mix
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + _mlp(cfg, lp, h2)
    return apply_norm(x, params["enc_ln_f"], cfg.norm)


def _cross_kv(cfg: ArchConfig, xp: dict, enc_out: torch.Tensor):
    """The cross-attention's keys / values from the encoder states."""
    b, n_frames = enc_out.shape[:2]
    kx = enc_out @ xp["wk"]
    vx = enc_out @ xp["wv"]
    if cfg.qkv_bias:
        kx, vx = kx + xp["bk"], vx + xp["bv"]
    return (kx.reshape(b, n_frames, cfg.n_kv_heads, cfg.hd),
            vx.reshape(b, n_frames, cfg.n_kv_heads, cfg.hd))


def _decoder_encdec(cfg: ArchConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, enc_out: torch.Tensor,
                    attn_impl: str, collect_cache: bool, max_seq: int,
                    last_only: bool = False):
    b, s = x.shape[:2]
    x = x + sinusoidal_positions(s, cfg.d_model, x.dtype, x.device)[None]
    dec_cfg = dataclasses.replace(cfg, rope_fraction=0.0)
    extras: dict[str, list] = {"k": [], "v": [], "cross_k": [],
                               "cross_v": []}
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        mix, k, v = _attn_block(dec_cfg, lp["attn"], h, positions,
                                causal=True, attn_impl=attn_impl)
        x = x + mix
        # cross attention: queries from the decoder, keys / values from
        # the encoder states
        hx = apply_norm(x, lp["ln_x"], cfg.norm)
        qx, _, _ = _qkv(dec_cfg, lp["xattn"], hx)
        kx_e, vx_e = _cross_kv(cfg, lp["xattn"], enc_out)
        xo = _attend(qx, kx_e, vx_e, causal=False, attn_impl=attn_impl)
        x = x + xo.reshape(b, s, -1) @ lp["xattn"]["wo"]
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + _mlp(cfg, lp, h2)
        if collect_cache:
            for key, val in (("k", k), ("v", v), ("cross_k", kx_e),
                             ("cross_v", vx_e)):
                extras[key].append(val)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    if last_only:
        x = x[:, -1:]
    logits = x @ params["lm_head"].T
    cache = None
    if collect_cache:
        cache = _build_cache(cfg, {"k": torch.stack(extras["k"]),
                                   "v": torch.stack(extras["v"])},
                             b, s, max_seq or s)
        cache["cross_k"] = torch.stack(extras["cross_k"])
        cache["cross_v"] = torch.stack(extras["cross_v"])
    return logits, cache


# --------------------------------------------------------------------------
# serving: prefill + single-token decode
# --------------------------------------------------------------------------

@torch.no_grad()
def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            max_seq: int, *, attn_impl: str = "dense",
            enc_inputs: Optional[torch.Tensor] = None):
    """Full-prompt prefill.  Returns (last-position logits (B, V), serving
    cache)."""
    logits, cache = forward(cfg, params, tokens, attn_impl=attn_impl,
                            enc_inputs=enc_inputs, collect_cache=True,
                            last_only=True, max_seq=max_seq)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One decode step.  tokens: (B,) int.  Returns (logits (B, V), the
    new cache).  The cache's K/V and state tensors are updated IN PLACE
    (the reference donates them to its scan carry); the returned dict
    holds them with ``len`` advanced by one."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None, :]
    lens = cache["len"]
    positions = lens[:, None]
    spec = cfg.ssm_spec if cfg.family in ("ssm", "hybrid") else None
    is_encdec = cfg.family == "encdec"
    dec_cfg = dataclasses.replace(cfg, rope_fraction=0.0) if is_encdec \
        else cfg
    if is_encdec:
        # sinusoidal position embedding gathered at each request's length
        pe = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.dtype,
                                  x.device)
        x = x + pe[lens.long()][:, None, :]

    def ssm_step(lp, li, h):
        out, st = ssd_decode_step(
            lp["ssm"], spec, h, SSMState(cache["ssm"][li], cache["conv"][li]))
        cache["ssm"][li] = st.ssm
        cache["conv"][li] = st.conv
        return out

    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        if cfg.family == "ssm":
            mix = ssm_step(lp, li, h)
        else:
            q, k, v = _qkv(dec_cfg, lp["attn"], h)
            if dec_cfg.rope_fraction > 0:
                q = apply_rope(q, positions, cfg.rope_fraction,
                               cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_fraction,
                               cfg.rope_theta)
            if cfg.window > 0:
                kc, vc = kvcache.update_ring_cache(
                    cache["k"][li], cache["v"][li], k, v, lens, cfg.window)
                o = decode_attention(q, kc, vc,
                                     torch.clamp(lens + 1, max=cfg.window))
            else:
                kc, vc = kvcache.update_layer_cache(
                    cache["k"][li], cache["v"][li], k, v, lens)
                o = decode_attention(q, kc, vc, lens + 1)
            a_out = o.reshape(b, 1, -1) @ lp["attn"]["wo"]
            if cfg.family == "hybrid":
                mix = _hybrid_mix(lp, a_out, ssm_step(lp, li, h))
            else:
                mix = a_out
        x = x + mix
        if is_encdec:
            hx = apply_norm(x, lp["ln_x"], cfg.norm)
            qx, _, _ = _qkv(dec_cfg, lp["xattn"], hx)
            cross_k = cache["cross_k"][li]
            enc_len = torch.full((b,), cross_k.shape[1], dtype=torch.int32,
                                 device=x.device)
            xo = decode_attention(qx, cross_k, cache["cross_v"][li], enc_len)
            x = x + xo.reshape(b, 1, -1) @ lp["xattn"]["wo"]
        if cfg.family != "ssm":
            h2 = apply_norm(x, lp["ln2"], cfg.norm)
            x = x + _ffn(cfg, lp, h2)
    x = apply_norm(x, params["ln_f"], cfg.norm)
    logits = (x @ params["lm_head"].T)[:, 0]
    new_cache = dict(cache)
    new_cache["len"] = lens + 1
    return logits, new_cache


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


__all__ = ["ArchConfig", "SSMSpec", "spec_for", "init_params",
           "forward", "prefill", "decode_step", "greedy_generate",
           "layer_params", "resolve_device"]
