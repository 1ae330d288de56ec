"""Int8 KV-block quantize / dequantize: the wrappers of the CUDA kernels
``csrc/kv_quant.cu`` (port of ``repro.kernels.kv_quant``).

Quantization is symmetric per (block, layer, k|v) plane: one KV block is
``(L, 2, bs, Hkv, hd)`` and each of its ``L*2`` planes gets one fp32
scale, ``scale = absmax / 127``; values are ``round(x / scale)`` clamped
to +-127 as int8, and ``x' = q * scale`` comes back within ``scale / 2``
of ``x``.  Both kernels are bitwise equal to the plain versions in
``ref.py``.

The wrappers launch on CUDA tensors, on the caller's current stream (a
launch from the transfer worker runs on its copy stream), and raise on
anything the kernels do not take; ``repro_torch.kernels.ops`` sends CPU
tensors to the plain versions.  ``kv_block_quantize.launches`` and
``kv_block_dequantize.launches`` count the launches.
"""
from __future__ import annotations

import torch

from . import build
from .paged_attention import DTYPES, check_tensor, device_index


def _rows(shape) -> tuple[int, int]:
    if len(shape) != 6 or shape[2] != 2:
        raise ValueError(f"KV blocks must be (n, L, 2, bs, Hkv, hd), got "
                         f"{tuple(shape)}")
    n, lyr, two, bs, hkv, hd = shape
    return n * lyr * two, bs * hkv * hd


def kv_block_quantize(blocks: torch.Tensor):
    """blocks: (n, L, 2, bs, Hkv, hd) float32 or bfloat16 -> (int8 vals of
    the same shape, float32 scales (n, L, 2))."""
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if blocks.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {blocks.dtype}")
    check_tensor("blocks", blocks, dev, blocks.dtype, 6)
    r, e = _rows(blocks.shape)
    vals = torch.empty(blocks.shape, dtype=torch.int8, device=dev)
    scales = torch.empty(blocks.shape[:3], dtype=torch.float32, device=dev)
    err = build.library().proserve_kv_quantize(
        DTYPES[blocks.dtype], blocks.data_ptr(), vals.data_ptr(),
        scales.data_ptr(), r, e, device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "kv_block_quantize")
    build.count_launch(kv_block_quantize)
    return vals, scales


def kv_block_dequantize(vals: torch.Tensor, scales: torch.Tensor):
    """vals: (n, L, 2, bs, Hkv, hd) int8, scales: (n, L, 2) float32 ->
    float32 blocks of vals' shape."""
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    check_tensor("vals", vals, dev, torch.int8, 6)
    check_tensor("scales", scales, dev, torch.float32, 3)
    r, e = _rows(vals.shape)
    if tuple(scales.shape) != tuple(vals.shape[:3]):
        raise ValueError(f"scales {tuple(scales.shape)} do not match vals "
                         f"{tuple(vals.shape)}")
    out = torch.empty(vals.shape, dtype=torch.float32, device=dev)
    err = build.library().proserve_kv_dequantize(
        vals.data_ptr(), scales.data_ptr(), out.data_ptr(), r, e,
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "kv_block_dequantize")
    build.count_launch(kv_block_dequantize)
    return out


kv_block_quantize.launches = 0
kv_block_dequantize.launches = 0
