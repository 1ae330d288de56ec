"""Public kernel entry points, dispatched by the tensors' device (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel, which raises on a build
or launch failure; a CPU tensor takes the plain PyTorch version in
``ref.py``.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from . import ref
from .chunked_prefill import packed_prefill_attention as _packed_prefill
from .paged_attention import paged_decode_attention as _paged_decode


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


def packed_prefill_attention(q, k_cache, v_cache, ctx_lens):
    if _on_cuda(q):
        return _packed_prefill(q, k_cache, v_cache, ctx_lens)
    return ref.packed_prefill_attention_ref(q, k_cache, v_cache, ctx_lens)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since its counter was last reset."""
    return {"paged_decode_attention": _paged_decode.launches,
            "packed_prefill_attention": _packed_prefill.launches}


def reset_launch_counts() -> None:
    _paged_decode.launches = 0
    _packed_prefill.launches = 0
