"""Analytical executor: ground-truth batch latency for the cluster
simulator (copy of ``repro.sim.executor``; the hardware constants live on
the ``InstanceHardware`` object, TPU v5e by default, and ``H100_SXM``
describes the card the port serves on).

The paper measures wall-clock on Ascend-910B NPUs; offline we substitute a
roofline-grounded analytical model of a TPU v5e serving instance (DESIGN.md
§2).  Per batch:

    compute_s = FLOPs / (chips * PEAK * mfu)
    memory_s  = bytes  / (chips * HBM_BW * hbm_eff)
    latency   = max(compute_s, memory_s) + t_launch

FLOPs: linear layers 2*N_active per token + attention 4*L*d*sum(c*(k+c/2)).
Bytes: weights read ONCE per batch (the true nonlinearity the paper's linear
estimator approximates) + per-request KV reads + KV writes.

The default ``InstanceHardware()`` is the reference's TPU v5e instance,
constant for constant, so the default path gives the reference's numbers
bit for bit.  ``InstanceHardware.h100()`` is one NVIDIA H100 SXM card; it
prices fp32 weights (``ModelProfile.dtype_bytes == 4``) at the card's fp32
peak and narrower ones at its bf16 peak.

The schedulers never see this model — they use the fitted linear estimator
(Eq. 4-6), trained on profiled batches generated against this executor, so
estimator error propagates into scheduling realistically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.estimator import BatchLatencyEstimator, WorkItem

# TPU v5e hardware constants (also used by the roofline analysis)
PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
HBM_BW = 819e9               # bytes/s per chip
ICI_BW = 50e9                # bytes/s per link
HBM_BYTES = 16 * 1024**3     # per chip
HOST_LINK_BW = 32e9          # host<->device (PCIe gen4 x16 class)


@dataclass(frozen=True)
class ModelProfile:
    """Minimal model description for latency modeling."""
    name: str
    n_params: float              # total parameters
    n_active: float              # active per token (MoE: shared + top-k)
    n_layers: int
    d_model: int
    n_kv_heads: int
    head_dim: int
    dtype_bytes: int = 2

    @property
    def kv_bytes_per_token(self) -> float:
        return (2 * self.n_layers * self.n_kv_heads * self.head_dim
                * self.dtype_bytes)


QWEN2_7B = ModelProfile("qwen2-7b", 7.6e9, 7.6e9, 28, 3584, 4, 128)
QWEN3_32B = ModelProfile("qwen3-32b", 32.8e9, 32.8e9, 64, 5120, 8, 128)
# the model the port serves on the card: configs/qwen1_5_0_5b.py at its
# published width in fp32 (ArchConfig.param_count(): 24 layers of 12.8 M
# plus an untied embedding and lm_head of 151936 x 1024 each)
QWEN1_5_0_5B_FP32 = ModelProfile("qwen1.5-0.5b", 619_446_272, 619_446_272,
                                 24, 1024, 16, 64, dtype_bytes=4)


@dataclass(frozen=True)
class ChipConstants:
    """Per-chip peaks of one accelerator type."""
    name: str
    peak_flops: float            # dense bf16 FLOP/s per chip
    peak_flops_fp32: float       # dense fp32 FLOP/s per chip (no TF32)
    hbm_bw: float                # bytes/s per chip
    hbm_bytes: float             # device memory per chip
    host_link_bw: float          # host<->device bytes/s


H100_SXM = ChipConstants(
    "h100-sxm",
    peak_flops=989e12,           # dense bf16 tensor cores: H100 SXM datasheet
    peak_flops_fp32=67e12,       # fp32 outside the tensor cores: datasheet
    hbm_bw=3.35e12,              # HBM3: H100 SXM datasheet
    hbm_bytes=80e9,              # 80 GB HBM3: H100 SXM datasheet
    # measured on NVIDIA H100 80GB HBM3 @ 700 W: the serve phase of
    # chip_smoke.py landed its pinned D2H mirrors at t_block_measured =
    # 6.697e-5 s per 3 MiB Qwen1.5-0.5B fp32 KV block
    host_link_bw=3 * 2**20 / 6.697e-5)


@dataclass
class InstanceHardware:
    chips: int = 4               # TP degree of one serving instance
    # assumptions of the reference, not measurements: the achieved
    # fractions of the chip's peaks
    mfu: float = 0.5             # achieved fraction of peak on prefill
    hbm_eff: float = 0.8         # achieved fraction of HBM bandwidth
    t_launch: float = 3e-3       # per-iteration constant overhead (s)
    peak_flops: float = PEAK_FLOPS             # bf16 FLOP/s per chip
    # fp32 FLOP/s per chip; None prices fp32 weights at ``peak_flops``, as
    # the reference's v5e instance does
    peak_flops_fp32: Optional[float] = None
    hbm_bw: float = HBM_BW
    hbm_bytes: float = HBM_BYTES
    host_link_bw: float = HOST_LINK_BW

    @classmethod
    def h100(cls, chips: int = 1, **kw) -> "InstanceHardware":
        """One serving instance of ``chips`` H100 SXM cards; ``mfu``,
        ``hbm_eff`` and ``t_launch`` keep the reference's assumed values
        unless given (``t_launch`` can be set from a measured step floor)."""
        c = H100_SXM
        return cls(chips=chips, peak_flops=c.peak_flops,
                   peak_flops_fp32=c.peak_flops_fp32, hbm_bw=c.hbm_bw,
                   hbm_bytes=c.hbm_bytes, host_link_bw=c.host_link_bw, **kw)

    @property
    def flops_per_s(self) -> float:
        return self.chips * self.peak_flops * self.mfu

    def flops_per_s_for(self, dtype_bytes: int) -> float:
        """Achieved FLOP/s on weights of ``dtype_bytes`` bytes each."""
        if dtype_bytes == 4 and self.peak_flops_fp32 is not None:
            return self.chips * self.peak_flops_fp32 * self.mfu
        return self.flops_per_s

    @property
    def bytes_per_s(self) -> float:
        return self.chips * self.hbm_bw * self.hbm_eff


class AnalyticalExecutor:
    """Ground-truth batch latency + derived block-pool geometry."""

    def __init__(self, model: ModelProfile, hw: InstanceHardware,
                 block_size: int = 16,
                 kv_memory_fraction: float = 0.35):
        self.model = model
        self.hw = hw
        self.block_size = block_size
        kv_pool_bytes = kv_memory_fraction * hw.chips * hw.hbm_bytes
        self.num_blocks = int(kv_pool_bytes //
                              (model.kv_bytes_per_token * block_size))
        # host<->device copy time for one KV block
        self.t_block = ((model.kv_bytes_per_token * block_size)
                        / hw.host_link_bw)

    # ------------------------------------------------------------------
    def batch_latency(self, items: list[WorkItem]) -> float:
        """items: (l_q, l_kv, is_prefill) per request in the batch."""
        if not items:
            return 0.0
        m = self.model
        if len(items) >= 32:
            # vectorized path, bitwise identical to the loop below: the two
            # per-item flops terms are interleaved into one array so the
            # sequential np.add.accumulate reproduces the loop's exact
            # rounding (np.sum's pairwise reduction would not)
            arr = np.asarray(items, dtype=np.float64)
            l_q, l_kv = arr[:, 0], arr[:, 1]
            terms = np.empty(2 * len(items))
            terms[0::2] = 2.0 * m.n_active * l_q
            terms[1::2] = 4.0 * m.n_layers * m.d_model * l_q \
                * (l_kv + l_q / 2.0)
            flops = float(np.add.accumulate(terms)[-1])
            kv_read = float(np.add.accumulate(
                (l_kv + l_q) * m.kv_bytes_per_token)[-1])
            new_tokens = int(arr[:, 0].astype(np.int64).sum())
        else:
            flops = 0.0
            kv_read = 0.0
            new_tokens = 0
            for l_q, l_kv, is_prefill in items:
                flops += 2.0 * m.n_active * l_q
                flops += 4.0 * m.n_layers * m.d_model * l_q * (l_kv + l_q / 2.0)
                kv_read += (l_kv + l_q) * m.kv_bytes_per_token
                new_tokens += l_q
        weight_read = m.n_params * m.dtype_bytes      # once per batch
        kv_write = new_tokens * m.kv_bytes_per_token
        compute_s = flops / self.hw.flops_per_s_for(m.dtype_bytes)
        memory_s = (weight_read + kv_read + kv_write) / self.hw.bytes_per_s
        return max(compute_s, memory_s) + self.hw.t_launch

    # ------------------------------------------------------------------
    def profile_batches(self, rng: np.random.Generator, n: int = 400,
                        max_prefill: int = 4096, max_ctx: int = 16384,
                        noise: float = 0.02,
                        ) -> tuple[list[list[WorkItem]], list[float]]:
        """Offline profiling set for fitting the linear estimator (§4.1)."""
        batches, lats = [], []
        for _ in range(n):
            kind = rng.random()
            items: list[WorkItem] = []
            if kind < 0.4:        # decode-heavy batch
                for _ in range(int(rng.integers(1, 64))):
                    items.append((1, int(rng.integers(16, max_ctx)), False))
            elif kind < 0.7:      # mixed
                for _ in range(int(rng.integers(1, 8))):
                    items.append((int(rng.integers(16, max_prefill // 4)),
                                  int(rng.integers(0, max_ctx // 4)), True))
                for _ in range(int(rng.integers(1, 32))):
                    items.append((1, int(rng.integers(16, max_ctx)), False))
            else:                 # prefill-heavy
                for _ in range(int(rng.integers(1, 4))):
                    items.append((int(rng.integers(64, max_prefill)),
                                  int(rng.integers(0, max_ctx // 2)), True))
            batches.append(items)
            lat = self.batch_latency(items)
            lats.append(lat * (1.0 + noise * rng.standard_normal()))
        return batches, lats

    def fit_estimator(self, seed: int = 0, n: int = 400,
                      ) -> tuple[BatchLatencyEstimator, float]:
        """Fit Eq. 4-6 on profiled batches; returns (estimator, MAPE)."""
        rng = np.random.default_rng(seed)
        batches, lats = self.profile_batches(rng, n=n)
        est = BatchLatencyEstimator.fit(batches, lats)
        hold_b, hold_l = self.profile_batches(
            np.random.default_rng(seed + 1), n=max(64, n // 4))
        return est, est.mape(hold_b, hold_l)
