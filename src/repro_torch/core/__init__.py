"""ProServe scheduling core (pure Python), copied from ``repro.core``.

The modules are verbatim copies so the port runs the same scheduler as
the JAX engine without importing the JAX package.  ``schedulers``,
``gorouting`` and ``prefix`` are not copied yet; the port builds its
policy as ``SlideBatching()``, which is what
``make_policy("slidebatching")`` returns in the reference.
"""
from .request import Request, SLO, Phase
from .tdg import tdg_gain, tdg_ratio, ideal_gain, weighted_slo_gain, ta_slo_gain
from .estimator import BatchLatencyEstimator
from .blocks import BlockManager, blocks_for
from .batching import BatchEntry, BatchPlan, EngineConfig, SchedView
from .slidebatching import SlideBatching
from .spec import (AcceptanceEWMA, SpecAccounting, expected_tokens,
                   policy_depth, price_depth, sim_accept_draw, useful_depth)

__all__ = [
    "Request", "SLO", "Phase", "tdg_gain", "tdg_ratio", "ideal_gain",
    "weighted_slo_gain", "ta_slo_gain", "BatchLatencyEstimator",
    "BlockManager", "blocks_for", "BatchEntry", "BatchPlan", "EngineConfig",
    "SchedView", "SlideBatching", "AcceptanceEWMA", "SpecAccounting",
    "expected_tokens", "policy_depth", "price_depth", "sim_accept_draw",
    "useful_depth",
]
