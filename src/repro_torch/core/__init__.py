"""ProServe scheduling core (pure Python), copied from ``repro.core``:
TDG gain, latency estimator, SlideBatching, block management, GoRouting,
the prefix registry and all baseline policies.

The modules are verbatim copies so the port runs the same scheduler and
router as the JAX engine without importing the JAX package.
"""
from .request import Request, SLO, Phase
from .tdg import tdg_gain, tdg_ratio, ideal_gain, weighted_slo_gain, ta_slo_gain
from .estimator import BatchLatencyEstimator
from .blocks import BlockManager, blocks_for
from .prefix import PrefixRegistry, SimPrefixCache, chunk_hashes
from .batching import BatchEntry, BatchPlan, EngineConfig, SchedView
from .slidebatching import SlideBatching
from .spec import (AcceptanceEWMA, SpecAccounting, expected_tokens,
                   policy_depth, price_depth, sim_accept_draw, useful_depth)
from .schedulers import make_policy, POLICIES
from .gorouting import (GoRouting, MinLoad, RoundRobin, RouterConfig,
                        InstanceState, QueuedStub, ROUTERS)

__all__ = [
    "Request", "SLO", "Phase", "tdg_gain", "tdg_ratio", "ideal_gain",
    "weighted_slo_gain", "ta_slo_gain", "BatchLatencyEstimator",
    "BlockManager", "blocks_for", "PrefixRegistry", "SimPrefixCache",
    "chunk_hashes", "BatchEntry", "BatchPlan", "EngineConfig",
    "SchedView", "SlideBatching", "AcceptanceEWMA", "SpecAccounting",
    "expected_tokens", "policy_depth", "price_depth", "sim_accept_draw",
    "useful_depth", "make_policy", "POLICIES", "GoRouting",
    "MinLoad", "RoundRobin", "RouterConfig", "InstanceState", "QueuedStub",
    "ROUTERS",
]
