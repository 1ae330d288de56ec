"""Discrete-event cluster simulator calibrated by the analytical executor
— the substrate for all paper-scale experiments (DESIGN.md §2); copy of
``repro.sim``.

``workloads``, ``metrics``, ``engine_sim``, ``cluster``, ``vector``,
``windowed`` and ``shard`` are verbatim copies of the reference modules
(numpy only, relative imports onto ``repro_torch.core``), so the port
simulates exactly what ``repro.sim`` simulates without importing the JAX
package.  ``executor`` is the copy with the hardware constants moved onto
``InstanceHardware`` (TPU v5e by default, bit for bit the reference) and
an H100 SXM constant set (``H100_SXM``, ``InstanceHardware.h100()``) with
a Qwen1.5-0.5B fp32 model profile.  ``replay`` copies the simulated-time
paths verbatim; its frontend mode drives the port's torch engines.
"""
from .executor import (AnalyticalExecutor, ChipConstants, H100_SXM,
                       InstanceHardware, ModelProfile, QWEN1_5_0_5B_FP32,
                       QWEN2_7B, QWEN3_32B, PEAK_FLOPS, HBM_BW, ICI_BW,
                       HBM_BYTES, HOST_LINK_BW)
from .engine_sim import DecodeAllPolicy, EngineSim, StepResult
from .cluster import ClusterConfig, ClusterSim, HANDOFF_DELAY
from .vector import VectorClusterSim, VectorSlideBatching, vectorize_policy
from .windowed import WindowedClusterSim
from .shard import (ReplicaShard, ShardedWindowReplay, merge_counters,
                    replay_sim_sharded)
from .workloads import (WORKLOADS, WorkloadSpec, SCALE_SPEC,
                        iter_scale_trace, scale_mix)
from .metrics import (DISAGG_COUNTERS, SPEC_COUNTERS, StreamingSummary,
                      Summary, disagg_counters, spec_counters, summarize,
                      gain_timeline, urgent_timeout_timeline)
from .replay import (ReplayReport, clip_lengths, replay_frontend,
                     replay_sim, replay_sim_stream, synth_prompt)

__all__ = [
    "AnalyticalExecutor", "InstanceHardware", "ModelProfile", "QWEN2_7B",
    "QWEN3_32B", "PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_BYTES",
    "HOST_LINK_BW", "DecodeAllPolicy", "EngineSim", "StepResult",
    "ClusterConfig", "ClusterSim", "HANDOFF_DELAY", "VectorClusterSim",
    "VectorSlideBatching", "vectorize_policy", "WindowedClusterSim",
    "ReplicaShard", "ShardedWindowReplay", "merge_counters",
    "replay_sim_sharded", "WORKLOADS", "WorkloadSpec",
    "SCALE_SPEC", "iter_scale_trace", "scale_mix", "DISAGG_COUNTERS",
    "SPEC_COUNTERS", "StreamingSummary", "Summary", "disagg_counters",
    "spec_counters", "summarize", "gain_timeline",
    "urgent_timeout_timeline",
    "ReplayReport", "clip_lengths", "replay_frontend", "replay_sim",
    "replay_sim_stream", "synth_prompt",
    "ChipConstants", "H100_SXM", "QWEN1_5_0_5B_FP32",
]
