"""Serving runtime on the card: paged KV pool with its tiered host store,
model execution against it, radix prefix cache, background transfer lanes
and the continuous-batching engine (port of ``repro.serving``, colocated
role)."""
from .kv_pool import KVTierStore, PagedKVPool
from .prefix_cache import RadixPrefixCache
from .transfer import TransferDone, TransferWorker
from .engine import Engine, EngineStats

__all__ = ["KVTierStore", "PagedKVPool", "RadixPrefixCache",
           "TransferDone", "TransferWorker", "Engine", "EngineStats"]
