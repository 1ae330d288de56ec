"""Weights bridge between the reference's parameter tree and the port's.

The JAX package's ``init_params`` returns a pytree of arrays with layer
parameters stacked on axis 0; ``jax.tree.map(np.asarray, params)`` turns
it into nested dicts of numpy arrays, which ``params_from_numpy`` maps
onto torch tensors leaf for leaf.  The layouts are kept as they are
(``wq`` (L, d, H*hd), ``lm_head`` (V, d)), so the port's functions read
the same arrays the reference reads.  The SSM leaves ``A_log``, ``D`` and
``dt_bias`` stay fp32 whatever ``dtype``, as the reference builds them.
"""
from __future__ import annotations

import numpy as np
import torch

from .ssm import FP32_LEAVES


def params_from_numpy(tree: dict, device="cuda",
                      dtype=torch.float32) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors, in
    ``dtype`` except the fp32 SSM leaves."""
    return {k: params_from_numpy(v, device, dtype) if isinstance(v, dict)
            else _leaf(v, device,
                       torch.float32 if k in FP32_LEAVES else dtype)
            for k, v in tree.items()}


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: torch cannot wrap it
        a = a.astype(np.float32)         # exact
    # a copy: the tree's arrays may be read-only views of JAX buffers
    return torch.tensor(a).to(device=device, dtype=dtype)


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: float32 numpy leaves on the host."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
