"""Serving runtime on the card: paged KV pool with its tiered host store,
model execution against it, radix prefix cache, background transfer lanes,
the continuous-batching engine in its colocated, prefill and decode roles,
and the synchronous GoRouting service controller over a fleet of them
(port of ``repro.serving``)."""
from .kv_pool import KVTierStore, PagedKVPool
from .prefix_cache import RadixPrefixCache
from .transfer import TransferDone, TransferWorker
from .engine import (Engine, EngineStats, HandoffAdopted, HandoffDropped,
                     HandoffEvent, HandoffPayload)
from .dispatch import RouterBook
from .service import ServiceConfig, ServiceController

__all__ = ["KVTierStore", "PagedKVPool", "RadixPrefixCache",
           "TransferDone", "TransferWorker", "Engine", "EngineStats",
           "HandoffAdopted", "HandoffDropped", "HandoffEvent",
           "HandoffPayload", "RouterBook", "ServiceConfig",
           "ServiceController"]
