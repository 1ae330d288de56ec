"""Weights made by the benchmark from ``--seed``, on the device, one
``normal_`` call per stacked leaf, in the layout the port's engine takes
(``repro_torch.models.model``: layers stacked on axis 0, ``wq`` as
(d, H*hd), ``lm_head`` as (V, d)).  The program and the plain reference
are handed the same tensors.

Scales: matrices N(0, 1/fan_in); ``wo`` also divided by sqrt(2 L);
embeddings and the head 0.02; biases N(0, 0.1^2) and norm scales
1 + N(0, 0.1^2), so that a path that drops a bias or a scale shows.
"""
from __future__ import annotations

import torch


def seed_int(seed: int) -> int:
    """Any whole number, as the non-negative 63-bit seed torch takes."""
    return int(seed) % (1 << 63)


def make_weights(arch, seed: int, device, dtype=torch.float32) -> dict:
    if arch.family != "dense" or arch.norm != "rmsnorm" \
            or arch.act != "swiglu":
        raise NotImplementedError(
            f"the benchmark makes weights for rmsnorm/swiglu dense "
            f"models, not {arch.family}/{arch.norm}/{arch.act}")
    g = torch.Generator(device).manual_seed(seed_int(seed))
    d, hd, L = arch.d_model, arch.hd, arch.n_layers
    H, Hkv = arch.n_heads, arch.n_kv_heads

    def normal(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(mean, std, generator=g)

    def scale(shape):
        return normal(shape, 0.1, 1.0)

    attn = {"wq": normal((L, d, H * hd), d ** -0.5),
            "wk": normal((L, d, Hkv * hd), d ** -0.5),
            "wv": normal((L, d, Hkv * hd), d ** -0.5),
            "wo": normal((L, H * hd, d), (H * hd * 2 * L) ** -0.5)}
    if arch.qkv_bias:
        attn.update(bq=normal((L, H * hd), 0.1), bk=normal((L, Hkv * hd), 0.1),
                    bv=normal((L, Hkv * hd), 0.1))
    if arch.qk_norm:
        attn.update(q_norm=scale((L, hd)), k_norm=scale((L, hd)))
    layers = {"ln1": {"scale": scale((L, d))}, "ln2": {"scale": scale((L, d))},
              "attn": attn}
    f = arch.d_ff
    layers["mlp"] = {"w_gate": normal((L, d, f), d ** -0.5),
                     "w_up": normal((L, d, f), d ** -0.5),
                     "w_down": normal((L, f, d), f ** -0.5)}
    return {"embed": normal((arch.vocab, d), 0.02),
            "lm_head": normal((arch.vocab, d), 0.02),
            "ln_f": {"scale": scale((d,))},
            "layers": layers}


def nbytes(tree: dict) -> int:
    return sum(nbytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())

