"""Kernels of the serving path: CUDA C++ for Hopper in ``csrc/``, their
wrappers, and the plain PyTorch versions (port of ``repro.kernels``)."""
from .ops import (block_gather, chunked_prefill_attention,
                  kv_block_dequantize, kv_block_quantize, launch_counts,
                  packed_prefill_attention, packed_verify_attention,
                  paged_decode_attention, reset_launch_counts)

__all__ = ["block_gather", "chunked_prefill_attention",
           "kv_block_dequantize", "kv_block_quantize", "launch_counts",
           "packed_prefill_attention", "packed_verify_attention",
           "paged_decode_attention", "reset_launch_counts"]
