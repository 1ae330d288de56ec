"""Serving runtime on the card: paged KV pool with its tiered host store,
model execution against it, radix prefix cache, background transfer lanes,
the continuous-batching engine in its colocated, prefill and decode roles,
threaded engine drivers, the synchronous GoRouting service controller and
the async streaming front-end over a fleet of them (port of
``repro.serving``)."""
from .kv_pool import KVTierStore, PagedKVPool
from .prefix_cache import RadixPrefixCache
from .spec import DraftRunner
from .transfer import TransferDone, TransferWorker
from .engine import (DriverDied, DriverFailed, Engine, EngineDriver,
                     EngineStats, HandoffAdopted, HandoffDropped,
                     HandoffEvent, HandoffPayload, StepEvent, TokenEvent)
from .dispatch import RouterBook
from .service import ServiceConfig, ServiceController
from .frontend import (AdmissionError, FrontendConfig, RequestStream,
                       ServiceFrontend)

__all__ = ["KVTierStore", "PagedKVPool", "RadixPrefixCache", "DraftRunner",
           "TransferDone", "TransferWorker", "Engine", "EngineDriver",
           "EngineStats", "DriverDied", "DriverFailed", "HandoffAdopted",
           "HandoffDropped", "HandoffEvent", "HandoffPayload", "StepEvent",
           "TokenEvent", "RouterBook", "ServiceConfig", "ServiceController",
           "AdmissionError", "FrontendConfig", "RequestStream",
           "ServiceFrontend"]
