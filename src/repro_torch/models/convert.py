"""Weights bridge between the reference's parameter tree and the port's.

The JAX package's ``init_params`` returns a pytree of arrays with layer
parameters stacked on axis 0; ``jax.tree.map(np.asarray, params)`` turns
it into nested dicts of numpy arrays, which ``params_from_numpy`` maps
onto torch tensors leaf for leaf.  The layouts are kept as they are
(``wq`` (L, d, H*hd), ``lm_head`` (V, d)), so the port's functions read
the same arrays the reference reads.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree: dict, device="cuda",
                      dtype=torch.float32) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).to(device=device, dtype=dtype)


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: float32 numpy leaves on the host."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
