"""One simulated multi-node cell: (dataset, rate, scheduler, router, PD
mode) through ``ClusterSim`` — the construction behind ``serve --mode
sim``.

The reference launcher builds this cell in ``benchmarks/common.py``
(``get_exec``, ``make_sched``, ``run_multi_node``), which imports the JAX
package; the port keeps its own copy here.  ``hardware="v5e"`` (the
default) is the reference's cell bit for bit; ``hardware="h100"`` prices
batches on H100 SXM cards (``InstanceHardware.h100``), and the model
``qwen1.5-0.5b`` is the fp32 Qwen1.5-0.5B that the port serves.
"""
from __future__ import annotations

from typing import Optional

from ..core import (EngineConfig, GoRouting, MinLoad, RoundRobin,
                    RouterConfig, make_policy)
from ..core.slidebatching import SlideBatching
from ..sim import (AnalyticalExecutor, ClusterConfig, ClusterSim,
                   InstanceHardware, QWEN1_5_0_5B_FP32, QWEN2_7B, QWEN3_32B,
                   summarize)
from ..sim.workloads import WORKLOADS

MODELS = {"qwen2-7b": QWEN2_7B, "qwen3-32b": QWEN3_32B,
          "qwen1.5-0.5b": QWEN1_5_0_5B_FP32}
HARDWARE = {"v5e": InstanceHardware, "h100": InstanceHardware.h100}
CHIPS = {"v5e": 4, "h100": 1}     # chips per instance

_EXEC_CACHE: dict = {}


def get_exec(model_name: str = "qwen2-7b", chips: Optional[int] = None,
             hardware: str = "v5e"):
    """(executor, fitted estimator, held-out MAPE), cached per cell."""
    chips = CHIPS[hardware] if chips is None else chips
    key = (model_name, chips, hardware)
    if key not in _EXEC_CACHE:
        ex = AnalyticalExecutor(MODELS[model_name],
                                HARDWARE[hardware](chips=chips))
        est, mape = ex.fit_estimator(n=300)
        _EXEC_CACHE[key] = (ex, est, mape)
    return _EXEC_CACHE[key]


def make_sched(name: str, **kw):
    if name.startswith("slide"):
        parts = dict()
        if "only_deadline" in name:
            parts = dict(use_density=False)
        elif "only_density" in name:
            parts = dict(use_deadline=False)
        elif "no_latency" in name:
            parts = dict(latency_aware_budget=False)
        return SlideBatching(**parts)
    return make_policy(name)


def run_multi_node(dataset: str, rate: float, sched: str, router: str, *,
                   pd_mode: str = "coloc", n_prefill: int = 4,
                   n_decode: int = 0, model: str = "qwen2-7b",
                   duration: float = 20.0, seed: int = 0, w_p: float = 4.0,
                   chips: Optional[int] = None, hardware: str = "v5e",
                   kills=None, router_cfg=None):
    ex, est, _ = get_exec(model, chips, hardware)
    reqs = WORKLOADS[dataset](rate=rate, duration=duration, seed=seed)
    if router == "gorouting":
        rt = GoRouting(est, router_cfg or RouterConfig(pd_mode=pd_mode))
    elif router == "round_robin":
        rt = RoundRobin(est)
    else:
        rt = MinLoad(est)
    cs = ClusterSim(lambda: make_sched(sched), rt, ex, est,
                    EngineConfig(w_p=w_p),
                    ClusterConfig(pd_mode=pd_mode, n_prefill=n_prefill,
                                  n_decode=n_decode))
    cs.run(reqs, kills=kills)
    s = summarize(reqs, w_p=w_p)
    return {"dataset": dataset, "rate": rate, "sched": sched,
            "router": router, "pd": pd_mode,
            "n_inst": n_prefill + n_decode, **s.row()}, reqs
