"""Public kernel entry points, dispatched by the tensors' device (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel, which raises on a build
or launch failure; a CPU tensor takes the plain PyTorch version in
``ref.py``.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from . import build, ref
from .block_gather import block_gather as _block_gather
from .chunked_prefill import chunked_prefill_attention as _chunked_prefill
from .chunked_prefill import packed_prefill_attention as _packed_prefill
from .kv_quant import kv_block_dequantize as _kv_dequant
from .kv_quant import kv_block_quantize as _kv_quant
from .paged_attention import paged_decode_attention as _paged_decode
from .spec_verify import packed_verify_attention as _packed_verify

_WRAPPERS = {"paged_decode_attention": _paged_decode,
             "packed_prefill_attention": _packed_prefill,
             "chunked_prefill_attention": _chunked_prefill,
             "packed_verify_attention": _packed_verify,
             "kv_block_quantize": _kv_quant,
             "kv_block_dequantize": _kv_dequant,
             "block_gather": _block_gather}


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    if _on_cuda(q):
        return _paged_decode(q, k_pages, v_pages, block_tables, lengths)
    return ref.paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths)


def packed_verify_attention(q, k_pages, v_pages, block_tables, lengths,
                            row_seg):
    """Verify rows read ``block_tables[row_seg]`` (see ``spec_verify``)."""
    if _on_cuda(q):
        return _packed_verify(q, k_pages, v_pages, block_tables, lengths,
                              row_seg)
    return ref.packed_verify_attention_ref(q, k_pages, v_pages, block_tables,
                                           lengths, row_seg)


def chunked_prefill_attention(q, k_cache, v_cache, cache_lens):
    """One chunk per row of q against its staged cache; ``cache_lens``
    include the chunk."""
    if _on_cuda(q):
        return _chunked_prefill(q, k_cache, v_cache, cache_lens)
    return ref.chunked_prefill_attention_ref(q, k_cache, v_cache, cache_lens)


def packed_prefill_attention(q, k_cache, v_cache, ctx_lens):
    if _on_cuda(q):
        return _packed_prefill(q, k_cache, v_cache, ctx_lens)
    return ref.packed_prefill_attention_ref(q, k_cache, v_cache, ctx_lens)


def kv_block_quantize(blocks):
    """(n, L, 2, bs, Hkv, hd) float -> (int8 vals, fp32 scales (n, L, 2))."""
    if _on_cuda(blocks):
        return _kv_quant(blocks)
    return ref.kv_block_quantize_ref(blocks)


def kv_block_dequantize(vals, scales):
    """(int8 vals, fp32 scales) -> fp32 blocks of vals' shape."""
    if _on_cuda(vals):
        return _kv_dequant(vals, scales)
    return ref.kv_block_dequantize_ref(vals, scales)


def block_gather(pool, indices, block_dim: int = 0):
    """Blocks ``indices`` of ``pool``'s axis ``block_dim``, moved to the
    front (contiguous on the card)."""
    if _on_cuda(pool):
        return _block_gather(pool, indices, block_dim)
    return ref.block_gather_ref(pool, indices, block_dim)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since its counter was last reset."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    build.reset_launches(_WRAPPERS.values())
