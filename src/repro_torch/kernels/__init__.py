"""Attention kernels of the serving path: CUDA C++ for Hopper in
``csrc/``, their wrappers, and the plain PyTorch versions (port of
``repro.kernels``)."""
from .ops import (launch_counts, packed_prefill_attention,
                  paged_decode_attention, reset_launch_counts)

__all__ = ["launch_counts", "packed_prefill_attention",
           "paged_decode_attention", "reset_launch_counts"]
