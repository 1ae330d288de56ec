"""Serving runtime on the card: paged KV pool, model execution against it,
radix prefix cache and the continuous-batching engine (port of
``repro.serving``, colocated role)."""
from .kv_pool import KVTierStore, PagedKVPool
from .prefix_cache import RadixPrefixCache
from .engine import Engine, EngineStats

__all__ = ["KVTierStore", "PagedKVPool", "RadixPrefixCache", "Engine",
           "EngineStats"]
