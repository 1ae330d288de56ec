"""Model substrate on torch tensors (port of ``repro.models``):
config-driven transformers of every family (dense / MoE / SSM / hybrid /
enc-dec) with prefill / decode caches."""
from .model import (ArchConfig, decode_step, forward, greedy_generate,
                    init_params, layer_params, prefill)
from .layers import (apply_rope, chunked_attention, decode_attention,
                     dense_attention, layernorm, rmsnorm)
from .ssm import SSMSpec, SSMState, ssd_chunked, ssd_decode_step
from .moe import moe_forward, moe_ref
from .convert import params_from_numpy, params_to_numpy

__all__ = ["ArchConfig", "init_params", "forward", "prefill", "decode_step",
           "dense_attention", "chunked_attention", "decode_attention",
           "apply_rope", "rmsnorm", "layernorm", "SSMSpec", "SSMState",
           "ssd_chunked", "ssd_decode_step", "moe_forward", "moe_ref",
           "greedy_generate", "layer_params", "params_from_numpy",
           "params_to_numpy"]
