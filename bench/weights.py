"""Weights made by the benchmark from ``--seed``, on the device, one
``normal_`` call per stacked leaf, in the layout the port's engine takes
(``repro_torch.models.model``: layers stacked on axis 0, ``wq`` as
(d, H*hd), ``lm_head`` as (V, d)).  The program and the plain reference
are handed the same tensors.

Scales: matrices N(0, 1/fan_in), fan_in the leaf's second-to-last axis
(the router and each expert's projections included); ``wo`` also divided
by sqrt(2 L); embeddings and the head 0.02; biases N(0, 0.1^2) and norm
scales 1 + N(0, 0.1^2), so that a path that drops a bias or a scale
shows.

Dense rmsnorm / swiglu models draw their leaves from one generator in
the fixed order of ``_dense``.  Every other model follows the port's own
layout: the leaf names and shapes of ``init_params(arch, None,
device="meta")`` (no memory), each leaf drawn by its role from a
generator of its own, seeded by the seed and the leaf's path, so a leaf's
values do not depend on which other leaves the layout holds or in what
order.  A leaf whose role is not known here raises.
"""
from __future__ import annotations

import hashlib

import torch

# the role of each leaf name in the port's layout
_MATRICES = {"wq", "wk", "wv", "w_gate", "w_up", "w_down", "router"}
_SCALES = {"scale", "q_norm", "k_norm"}
_BIASES = {"bq", "bk", "bv", "bias", "b_up", "b_down"}
_TABLES = {"embed", "lm_head"}


def seed_int(seed: int) -> int:
    """Any whole number, as the non-negative 63-bit seed torch takes."""
    return int(seed) % (1 << 63)


def make_weights(arch, seed: int, device, dtype=torch.float32) -> dict:
    if arch.family == "dense" and arch.norm == "rmsnorm" \
            and arch.act == "swiglu":
        return _dense(arch, seed, device, dtype)
    return _by_layout(arch, seed, device, dtype)


def _dense(arch, seed: int, device, dtype) -> dict:
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


def _leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.blake2b(f"{seed_int(seed)}/{path}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") % (1 << 63)


def _by_layout(arch, seed: int, device, dtype) -> dict:
    from repro_torch.models.model import init_params
    layout = init_params(arch, None, dtype=dtype, device="meta")

    def draw(path: str, like: torch.Tensor) -> torch.Tensor:
        name = path.rsplit(".", 1)[-1]
        shape = tuple(like.shape)
        if name in _MATRICES:
            mean, std = 0.0, shape[-2] ** -0.5
        elif name == "wo":
            mean, std = 0.0, (shape[-2] * 2 * arch.n_layers) ** -0.5
        elif name in _TABLES:
            mean, std = 0.0, 0.02
        elif name in _BIASES:
            mean, std = 0.0, 0.1
        elif name in _SCALES:
            mean, std = 1.0, 0.1
        else:
            raise NotImplementedError(
                f"the benchmark knows no role for the leaf {path!r} of "
                f"{arch.name} ({arch.family})")
        g = torch.Generator(device).manual_seed(_leaf_seed(seed, path))
        t = torch.empty(shape, dtype=like.dtype, device=device)
        return t.normal_(mean, std, generator=g)

    def walk(tree: dict, prefix: str) -> dict:
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                else draw(prefix + k, v) for k, v in tree.items()}
    return walk(layout, "")


def nbytes(tree: dict) -> int:
    return sum(nbytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())

