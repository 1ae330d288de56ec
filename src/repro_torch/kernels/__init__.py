"""Kernels of the serving path: CUDA C++ for Hopper in ``csrc/``, their
wrappers, and the plain PyTorch versions (port of ``repro.kernels``)."""
from .ops import (block_gather, kv_block_dequantize, kv_block_quantize,
                  launch_counts, packed_prefill_attention,
                  paged_decode_attention, reset_launch_counts)

__all__ = ["block_gather", "kv_block_dequantize", "kv_block_quantize",
           "launch_counts", "packed_prefill_attention",
           "paged_decode_attention", "reset_launch_counts"]
