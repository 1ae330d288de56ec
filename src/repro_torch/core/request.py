"""Request model: priority, SLOs, lifecycle and token timeline.

This module is pure Python (no JAX) so the identical scheduling core drives
both the discrete-event cluster simulator (sim/) and the real JAX engine
(serving/).  Time is a float in seconds; priorities are small ints where
LOWER value = HIGHER priority (1 = most important), matching the paper's
``P = {1..P}`` with ``w_1 >= ... >= w_P``.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional


class Phase(enum.Enum):
    WAITING = 0      # in queue, no prefill progress
    PREFILL = 1      # some (possibly chunked) prefill done, first token not out
    DECODE = 2       # first token emitted, generating
    FINISHED = 3     # all output tokens emitted


@dataclass(frozen=True)
class SLO:
    """Per-request latency targets (seconds)."""
    ttft: float
    tpot: float

    def token_deadline(self, arrival: float, i: int) -> float:
        """Absolute deadline of output token ``i`` (1-based), Eq. (3):

        deadline_{r,i} = TTFT_SLO + (i-1) * TPOT_SLO   (relative to arrival)
        """
        if i < 1:
            raise ValueError(f"token index must be >= 1, got {i}")
        return arrival + self.ttft + (i - 1) * self.tpot


_rid_counter = itertools.count()


@dataclass
class Request:
    """One inference request with an originating-client priority."""
    prompt_len: int
    output_len: int              # ground-truth output length (oracle only;
                                 # schedulers must not read it — see note)
    arrival: float
    slo: SLO
    priority: int = 2            # 1 = high
    weight: float = 1.0          # w_{p(r)} priority weight
    rid: int = field(default_factory=lambda: next(_rid_counter))
    client: int = 0              # originating client id (for VTC fairness)
    # prefix identity (workload-generator stamped): requests in the same
    # ``prefix_group`` share their first ``shared_prefix_len`` prompt
    # tokens.  The real engine matches on token CONTENT (radix cache) and
    # ignores these; the simulator and trace replay use them to model /
    # synthesize shared prefixes.  -1 = no shared prefix.
    prefix_group: int = -1
    shared_prefix_len: int = 0

    # --- mutable serving state -------------------------------------------
    prefilled: int = 0           # prompt tokens whose KV exists on device
    host_prefilled: int = 0      # prompt tokens whose KV was computed but
                                 # currently lives in HOST memory (evicted)
    out_times: list[float] = field(default_factory=list)  # emission stamps
    first_scheduled: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0
    starving: bool = False       # anti-starvation promotion flag
    instance: Optional[int] = None   # routing assignment

    # ------------------------------------------------------------------
    @property
    def phase(self) -> Phase:
        if self.finish_time is not None:
            return Phase.FINISHED
        if self.out_times:
            return Phase.DECODE
        if self.prefilled > 0 or self.host_prefilled > 0:
            return Phase.PREFILL
        return Phase.WAITING

    @property
    def generated(self) -> int:
        return len(self.out_times)

    @property
    def next_token_index(self) -> int:
        """1-based index of the next output token to be produced."""
        return self.generated + 1

    @property
    def context_len(self) -> int:
        """Tokens of KV context currently implied (prompt progress + output)."""
        return self.prefilled + self.host_prefilled + self.generated

    @property
    def remaining_prompt(self) -> int:
        return self.prompt_len - self.prefilled - self.host_prefilled

    def next_deadline(self) -> float:
        """Absolute deadline of the token this request will emit next."""
        return self.slo.token_deadline(self.arrival, self.next_token_index)

    def remain(self, now: float) -> float:
        """``r.remain`` of Alg. 1: time left until the next token's deadline."""
        return self.next_deadline() - now

    def emit_token(self, t: float) -> None:
        if self.phase == Phase.FINISHED:
            raise RuntimeError(f"request {self.rid} already finished")
        if self.out_times and t < self.out_times[-1]:
            raise ValueError("token timestamps must be non-decreasing")
        self.out_times.append(t)
        if len(self.out_times) >= self.output_len:
            self.finish_time = t

    # --- observed latency metrics -----------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        return (self.out_times[0] - self.arrival) if self.out_times else None

    @property
    def tpot(self) -> Optional[float]:
        """Average time-per-output-token after the first token."""
        if len(self.out_times) < 2:
            return None
        span = self.out_times[-1] - self.out_times[0]
        return span / (len(self.out_times) - 1)

    def met_slo(self) -> bool:
        """Request-level SLO attainment: TTFT and TPOT both under target."""
        if self.ttft is None:
            return False
        ok_ttft = self.ttft < self.slo.ttft
        t = self.tpot
        ok_tpot = True if t is None else (t < self.slo.tpot)
        return ok_ttft and ok_tpot

    def __repr__(self) -> str:  # compact, used in logs
        return (f"Req({self.rid} p{self.priority} w{self.weight} "
                f"in={self.prompt_len} out={self.generated}/{self.output_len} "
                f"{self.phase.name})")
