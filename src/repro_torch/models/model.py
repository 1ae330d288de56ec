"""Config-driven model assembly on torch tensors (port of
``repro.models.model``): every family of the reference (dense / moe /
ssm / hybrid / encdec).

``ArchConfig`` is a field-for-field copy of the reference dataclass, so the
twelve config files under ``repro_torch/configs`` are the same data, plus
three fields the reference lacks (``PORT_FIELDS``) for published models it
renders otherwise: QK-norm over the whole projection, top-k gates not
renormalised, the RMSNorms' epsilon.  At their defaults the arithmetic is
the reference's, bit for bit.
Parameters are a plain nested dict of tensors in the reference's layout:
layer parameters STACKED on a leading axis, ``wq`` as (d, H*hd) and
``lm_head`` as (V, d).  Where JAX scans over the stacked layers, the port
loops over them in Python (``unstack_layers`` splits the stack into
per-layer views; ``layer_params`` indexes one layer).

Public entry points:
  * ``init_params(cfg, generator, ...)``  random parameters from a seed
  * ``forward(cfg, params, tokens, ...)`` full-sequence logits (and, with
    ``collect_cache``, a serving cache), under ``torch.no_grad``: serving
    builds no autograd graph
  * ``forward_train(cfg, params, tokens, ...)`` the same body without the
    decorator, for the training loss; ``remat`` recomputes each layer in
    the backward pass (the reference's per-layer ``jax.checkpoint``)
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
from torch.utils.checkpoint import checkpoint

from . import kvcache, moe
from .layers import (apply_norm, apply_rope, batch_only, chunked_attention,
                     decode_attention, dense_attention, dense_init, gelu_mlp,
                     no_shard, on_batch_shards, pinned, rmsnorm,
                     sinusoidal_positions, split_back, splittable, swiglu)
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
    norm_topk_prob: bool = True  # top-k gates: softmax over the top-k
    # logits (True), or the softmax over all E logits at the top k (False)
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    qk_norm_whole: bool = False  # one RMSNorm over the whole q (k)
    # projection before the heads split, not one per head
    rope_fraction: float = 1.0
    rope_theta: float = 1e4
    window: int = 0              # sliding-window size (hybrid)
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_frames: int = 0          # stub-frontend sequence length
    # --- misc ---
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6       # epsilon of ln1, ln2, ln_f, q/k norms
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


# the fields of ``ArchConfig`` that the reference's dataclass lacks
PORT_FIELDS = ("norm_topk_prob", "qk_norm_whole", "norm_eps")


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; a CUDA device with no card raises instead of falling back.
    ``meta`` (shapes and dtypes, no memory) serves the step builders'
    stand-in trees (``launch.steps``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
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
            p["q_norm"] = const((L, cfg.n_heads * hd if cfg.qk_norm_whole
                                 else hd), 1.0)
            p["k_norm"] = const((L, cfg.n_kv_heads * hd if cfg.qk_norm_whole
                                 else hd), 1.0)
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


def unstack_layers(tree: dict, n: int) -> list[dict]:
    """Every layer of the stacked layer tree, as views: one ``unbind`` per
    leaf, whose backward stacks the layers' gradients once (indexing each
    layer apart would write a zero-filled (L, ...) gradient per layer)."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) \
            else torch.unbind(v, 0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _layer_call(fn, remat: bool):
    """``fn`` itself, or under activation checkpointing: its activations
    are dropped after the forward and recomputed in the backward."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# --------------------------------------------------------------------------
# attention sub-block (full sequence)
# --------------------------------------------------------------------------

def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd)."""
    t = splittable(t, t.ndim - 1, n)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) -> (..., n * hd)."""
    return split_back(o.reshape(*o.shape[:-2], -1), o.shape[-2])


def _qkv(cfg: ArchConfig, ap: dict, x: torch.Tensor):
    hd = cfg.hd
    x = batch_only(x)
    q = x @ ap["wq"]
    k = x @ ap["wk"]
    v = x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    if cfg.qk_norm and cfg.qk_norm_whole:
        q = rmsnorm(q, ap["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, ap["k_norm"], cfg.norm_eps)
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv_heads, hd)
    v = split_heads(v, cfg.n_kv_heads, hd)
    if cfg.qk_norm and not cfg.qk_norm_whole:
        q = rmsnorm(q, ap["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, ap["k_norm"], cfg.norm_eps)
    return q, k, v


def _attend(q, k, v, *, causal: bool, attn_impl: str, window: int = 0,
            shard_fn=None):
    if attn_impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window)
    return dense_attention(q, k, v, causal=causal, window=window,
                           shard_fn=shard_fn)


def _attn_block(cfg: ArchConfig, ap: dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool,
                attn_impl: str = "dense", shard_fn=None):
    """Returns (out, k, v) — k/v pre-repeat, post-rope, for cache storage.
    ``shard_fn`` reaches the dense core's score tiles (the chunked core
    takes none, as in the reference)."""
    q, k, v = _qkv(cfg, ap, x)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    o = _attend(q, k, v, causal=causal, attn_impl=attn_impl,
                window=cfg.window, shard_fn=shard_fn)
    out = pinned(merge_heads(o) @ ap["wo"])
    return out, k, v


def _mlp(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, lp["mlp"]) if cfg.act == "swiglu" \
        else gelu_mlp(h, lp["mlp"])


def _ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor,
         shard_fn=None) -> torch.Tensor:
    """The layer's feed-forward: routed experts (moe) or the dense MLP."""
    if cfg.family == "moe":
        kw = {} if shard_fn is None else {"shard_fn": shard_fn}
        return moe.moe_forward(h, lp["moe"], cfg.top_k, cfg.capacity_factor,
                               norm_topk_prob=cfg.norm_topk_prob, **kw)
    return _mlp(cfg, lp, h)


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  DTensor tokens are looked up by each rank in its
    own rows (``on_batch_shards``), in the table gathered whole onto every
    rank (an all-gather for the lookup alone; the leaf stays sharded):
    DTensor's own lookup over a vocab-sharded table yields a MaskPartial
    whose redistribution fails in the backward, and torch 2.11's DTensor
    has no rule for the lookup's backward over split rows."""
    return on_batch_shards(lambda p, t: p["table"][t], 1, {"table": table},
                           tokens)


def _hybrid_mix(lp: dict, a_out: torch.Tensor, s_out: torch.Tensor):
    return 0.5 * (rmsnorm(a_out, lp["attn_out_norm"]["scale"])
                  + rmsnorm(s_out, lp["ssm_out_norm"]["scale"]))


# --------------------------------------------------------------------------
# full-sequence forward (training / prefill)
# --------------------------------------------------------------------------

def forward_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                  attn_impl: str = "dense", remat: bool = False,
                  enc_inputs: Optional[torch.Tensor] = None,
                  collect_cache: bool = False, last_only: bool = False,
                  max_seq: int = 0, shard_fn=None):
    """The body of ``forward``, without ``torch.no_grad``: autograd records
    it when grad is enabled (the training loss calls it so).  ``remat``
    runs each decoder layer, encoder layer and enc-dec decoder layer under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps
    each scanned layer in ``jax.checkpoint``.  ``shard_fn(x, kind)`` is
    called where the reference calls it, with its kinds (``act``,
    ``attn_scores``, ``moe_dispatch`` / ``moe_combine``, ``kv_stack``,
    ``logits``), once per layer; None is the identity."""
    sh = shard_fn or no_shard
    b, s = tokens.shape
    x = sh(_embed(params["embed"], tokens), "act")
    positions = torch.arange(s, device=tokens.device)[None, :]

    if cfg.family == "encdec":
        enc_out = _encoder(cfg, params, enc_inputs, attn_impl, sh, remat)
        logits, cache = _decoder_encdec(cfg, params, x, positions, enc_out,
                                        attn_impl, sh, collect_cache,
                                        max_seq, last_only, remat)
        return (logits, cache) if collect_cache else logits

    spec = cfg.ssm_spec if cfg.family in ("ssm", "hybrid") else None

    def layer(x, lp):
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        st = k = v = None
        if cfg.family == "ssm":
            mix, st = ssd_chunked(lp["ssm"], spec, h)
        elif cfg.family == "hybrid":
            a_out, k, v = _attn_block(cfg, lp["attn"], h, positions,
                                      causal=True, attn_impl=attn_impl,
                                      shard_fn=sh)
            s_out, st = ssd_chunked(lp["ssm"], spec, h)
            mix = _hybrid_mix(lp, a_out, s_out)
        else:
            mix, k, v = _attn_block(cfg, lp["attn"], h, positions,
                                    causal=True, attn_impl=attn_impl,
                                    shard_fn=sh)
        x = sh(x + mix, "act")
        if cfg.family != "ssm":
            h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
            x = sh(x + _ffn(cfg, lp, h2, shard_fn), "act")
        return x, k, v, st

    call = _layer_call(layer, remat)
    extras: dict[str, list] = {"k": [], "v": [], "ssm": [], "conv": []}
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x, k, v, st = call(x, lp)
        if collect_cache:
            if k is not None:
                extras["k"].append(sh(k, "kv_stack"))
                extras["v"].append(sh(v, "kv_stack"))
            if st is not None:
                extras["ssm"].append(st.ssm)
                extras["conv"].append(st.conv)
    x = apply_norm(x, params["ln_f"], cfg.norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = sh(batch_only(x) @ params["lm_head"].T, "logits")
    if not collect_cache:
        return logits
    stacked = {key: torch.stack(vals) for key, vals in extras.items()
               if vals}
    return logits, _build_cache(cfg, stacked, b, s, max_seq or s)


@torch.no_grad()
def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            attn_impl: str = "dense",
            enc_inputs: Optional[torch.Tensor] = None,
            collect_cache: bool = False, last_only: bool = False,
            max_seq: int = 0, shard_fn=None):
    """Token logits (B, S, V) for a full sequence (``last_only``: (B, 1, V)
    for the final position only).  ``collect_cache`` returns (logits,
    serving cache of ``max_seq`` positions) instead, as the reference's
    ``forward`` does; without it only the logits come back (the serving
    engine keeps its cache in the paged pool).  Runs under
    ``torch.no_grad``, so serving records no graph even when the
    parameters require grad.  ``shard_fn``: as ``forward_train``."""
    return forward_train(cfg, params, tokens, attn_impl=attn_impl,
                         enc_inputs=enc_inputs, collect_cache=collect_cache,
                         last_only=last_only, max_seq=max_seq,
                         shard_fn=shard_fn)


def _zero_tail(t: torch.Tensor, n: int) -> torch.Tensor:
    """(L, B, s, ...) -> (L, B, s + n, ...), the new positions zero: a
    copy, by ``torch.cat`` (torch 2.11's DTensor cannot plan ``pad`` on a
    mesh of two dims)."""
    zeros = torch.zeros(t.shape[:2] + (n,) + t.shape[3:], dtype=t.dtype,
                        device=t.device)
    return torch.cat([t, zeros], dim=2)


def _ring(t: torch.Tensor, s: int, w: int) -> torch.Tensor:
    """(L, B, s, ...) positions -> the (L, B, w, ...) ring of the last
    ``w``: position p in slot p % w, empty slots zero; a copy."""
    if s < w:
        return _zero_tail(t, w - s)
    tail, r = t[:, :, s - w:], s % w
    return torch.cat([tail[:, :, w - r:], tail[:, :, :w - r]], dim=2)


def _build_cache(cfg: ArchConfig, extras: dict, b: int, s: int,
                 max_seq: int) -> dict:
    dev = next(iter(extras.values())).device
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=dev)}
    if "k" in extras:
        k, v = extras["k"], extras["v"]              # (L,B,S,Hkv,hd)
        if cfg.window > 0:
            # the trailing `window` positions in their ring slots (slot =
            # pos % window), placed by slicing out of place: DTensor
            # refuses an indexed write into a sequence-sharded cache
            cache["k"], cache["v"] = (_ring(t, s, cfg.window) for t in (k, v))
        else:
            pad = max_seq - s
            if pad < 0:
                raise ValueError(f"max_seq {max_seq} < prompt length {s}")
            cache["k"], cache["v"] = _zero_tail(k, pad), _zero_tail(v, pad)
    if "ssm" in extras:
        cache["ssm"], cache["conv"] = extras["ssm"], extras["conv"]
    return cache


# --------------------------------------------------------------------------
# encoder-decoder (whisper-style; frontend = stub embeddings)
# --------------------------------------------------------------------------

def _encoder(cfg: ArchConfig, params: dict, enc_inputs: torch.Tensor,
             attn_impl: str, sh=no_shard,
             remat: bool = False) -> torch.Tensor:
    if enc_inputs is None:
        raise ValueError(f"{cfg.name!r} is an encoder-decoder: pass "
                         "enc_inputs (B, frames, d_model)")
    n_frames = enc_inputs.shape[1]
    x = sh(enc_inputs + sinusoidal_positions(
        n_frames, cfg.d_model, enc_inputs.dtype, enc_inputs.device)[None],
        "act")
    positions = torch.arange(n_frames, device=x.device)[None, :]
    enc_cfg = dataclasses.replace(cfg, family="dense", rope_fraction=0.0)

    def layer(x, lp):
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        mix, _, _ = _attn_block(enc_cfg, lp["attn"], h, positions,
                                causal=False, attn_impl=attn_impl)
        x = sh(x + mix, "act")
        h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
        return sh(x + _mlp(cfg, lp, h2), "act")

    call = _layer_call(layer, remat)
    for lp in unstack_layers(params["enc_layers"], cfg.n_enc_layers):
        x = call(x, lp)
    return apply_norm(x, params["enc_ln_f"], cfg.norm, cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, xp: dict, enc_out: torch.Tensor):
    """The cross-attention's keys / values from the encoder states."""
    enc_out = batch_only(enc_out)
    kx = enc_out @ xp["wk"]
    vx = enc_out @ xp["wv"]
    if cfg.qkv_bias:
        kx, vx = kx + xp["bk"], vx + xp["bv"]
    return (split_heads(kx, cfg.n_kv_heads, cfg.hd),
            split_heads(vx, cfg.n_kv_heads, cfg.hd))


def _decoder_encdec(cfg: ArchConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, enc_out: torch.Tensor,
                    attn_impl: str, sh, collect_cache: bool, max_seq: int,
                    last_only: bool = False, remat: bool = False):
    b, s = x.shape[:2]
    x = x + sinusoidal_positions(s, cfg.d_model, x.dtype, x.device)[None]
    dec_cfg = dataclasses.replace(cfg, rope_fraction=0.0)

    def layer(x, lp, enc_out):
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        mix, k, v = _attn_block(dec_cfg, lp["attn"], h, positions,
                                causal=True, attn_impl=attn_impl)
        x = sh(x + mix, "act")
        # cross attention: queries from the decoder, keys / values from
        # the encoder states
        hx = apply_norm(x, lp["ln_x"], cfg.norm, cfg.norm_eps)
        qx, _, _ = _qkv(dec_cfg, lp["xattn"], hx)
        kx_e, vx_e = _cross_kv(cfg, lp["xattn"], enc_out)
        xo = _attend(qx, kx_e, vx_e, causal=False, attn_impl=attn_impl)
        x = sh(x + pinned(merge_heads(xo) @ lp["xattn"]["wo"]), "act")
        h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
        return sh(x + _mlp(cfg, lp, h2), "act"), k, v, kx_e, vx_e

    call = _layer_call(layer, remat)
    extras: dict[str, list] = {"k": [], "v": [], "cross_k": [],
                               "cross_v": []}
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x, k, v, kx_e, vx_e = call(x, lp, enc_out)
        if collect_cache:
            for key, val in (("k", k), ("v", v), ("cross_k", kx_e),
                             ("cross_v", vx_e)):
                extras[key].append(sh(val, "kv_stack"))
    x = apply_norm(x, params["ln_f"], cfg.norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = sh(batch_only(x) @ params["lm_head"].T, "logits")
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
            enc_inputs: Optional[torch.Tensor] = None, shard_fn=None):
    """Full-prompt prefill.  Returns (last-position logits (B, V), serving
    cache).  ``shard_fn``: as ``forward_train``."""
    logits, cache = forward(cfg, params, tokens, attn_impl=attn_impl,
                            enc_inputs=enc_inputs, collect_cache=True,
                            last_only=True, max_seq=max_seq,
                            shard_fn=shard_fn)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, shard_fn=None):
    """One decode step.  tokens: (B,) int.  Returns (logits (B, V), the
    new cache).  The cache's K/V and state tensors are updated IN PLACE
    (the reference donates them to its scan carry); the returned dict
    holds them with ``len`` advanced by one.  ``shard_fn(x, kind)`` is
    called where the reference calls it (``act_decode``, ``dec_scores``,
    ``moe_dispatch`` / ``moe_combine``, ``logits_decode``); None is the
    identity."""
    sh = shard_fn or no_shard
    b = tokens.shape[0]
    x = sh(_embed(params["embed"], tokens.long())[:, None, :], "act_decode")
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
        h = apply_norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
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
                                     torch.clamp(lens + 1, max=cfg.window),
                                     shard_fn=sh)
            else:
                kc, vc = kvcache.update_layer_cache(
                    cache["k"][li], cache["v"][li], k, v, lens)
                o = decode_attention(q, kc, vc, lens + 1, shard_fn=sh)
            a_out = o.reshape(b, 1, -1) @ lp["attn"]["wo"]
            if cfg.family == "hybrid":
                mix = _hybrid_mix(lp, a_out, ssm_step(lp, li, h))
            else:
                mix = a_out
        # each residual sum is reduced once, where the reference
        # all-reduces a row-parallel output: a Partial sum left so would
        # be all-reduced again at every use
        x = batch_only(x + mix)
        if is_encdec:
            hx = apply_norm(x, lp["ln_x"], cfg.norm, cfg.norm_eps)
            qx, _, _ = _qkv(dec_cfg, lp["xattn"], hx)
            cross_k = cache["cross_k"][li]
            enc_len = torch.full((b,), cross_k.shape[1], dtype=torch.int32,
                                 device=x.device)
            xo = decode_attention(qx, cross_k, cache["cross_v"][li], enc_len,
                                  shard_fn=sh)
            x = batch_only(x + xo.reshape(b, 1, -1) @ lp["xattn"]["wo"])
        if cfg.family != "ssm":
            h2 = apply_norm(x, lp["ln2"], cfg.norm, cfg.norm_eps)
            x = batch_only(x + _ffn(cfg, lp, h2, shard_fn))
    x = apply_norm(x, params["ln_f"], cfg.norm, cfg.norm_eps)
    logits = sh((batch_only(x) @ params["lm_head"].T)[:, 0],
                "logits_decode")
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
           "forward", "forward_train", "prefill", "decode_step",
           "greedy_generate", "layer_params", "unstack_layers",
           "resolve_device"]
