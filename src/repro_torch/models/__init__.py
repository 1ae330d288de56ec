"""Model substrate on torch tensors: ``ArchConfig``, the dense-family
forward and the layers it is built from (port of ``repro.models``)."""
from .model import (ArchConfig, forward, greedy_generate, init_params,
                    layer_params)
from .layers import apply_rope, dense_attention, layernorm, rmsnorm
from .convert import params_from_numpy, params_to_numpy

__all__ = ["ArchConfig", "forward", "greedy_generate", "init_params",
           "layer_params", "apply_rope", "dense_attention", "layernorm",
           "rmsnorm", "params_from_numpy", "params_to_numpy"]
