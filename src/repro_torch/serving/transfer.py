"""Background host<->device KV transfer lanes, the §4.3 mechanisms (port of
``repro.serving.transfer``).

The BlockManager models two serial copy lanes (D2H offload, H2D reload)
whose occupancy drives the adaptive copy budget.  This module is the
matching mechanism: one worker thread that performs the copies off the
engine's critical path, so ``Engine.step()`` only enqueues transfers and
drains completions.

* **D2H offload ring.**  The engine snapshots the blocks to mirror with
  one ``block_gather`` launch (``PagedKVPool.gather_blocks``) into a fresh
  device tensor and hands it to the worker.  The JAX reference is
  race-free because its arrays are functional; here the snapshot is safe
  by construction: ``offload`` records an event on the engine's stream
  right after the gather and marks the snapshot as used by the copy
  stream (``record_stream``), the job holds the tensor until its copy is
  synchronised, and the copy stream waits on the event before it reads.
  The copy lands in pinned host memory (``non_blocking``), the worker
  blocks in ``synchronize()``, which releases the GIL, and then moves the
  blocks to pageable memory so the pinned buffer is reused.  The
  completion carries the host blocks, the block count and the measured
  copy time (the DMA alone).

* **H2D reload staging (double-buffered).**  The engine hints which
  evicted requests are likely to reload next round; the worker uploads
  their host blocks from pinned memory on its copy stream into a device
  buffer the next reload consumes.  At most ``max_staged`` requests are
  staged at a time.  The buffer is written on the copy stream; the
  consumer on the engine's stream waits on the staging event and marks
  the buffer ``record_stream`` there (``take_staged``), so the caching
  allocator cannot hand its memory out while the engine still reads it.

Both lanes speak the tiered wire format: a D2H job whose snapshot was
quantized on device carries an ``(int8 vals, fp32 scales)`` pair and
lands as per-block tuples (the pool routes them into the cold tier); an
H2D job whose payloads are such tuples uploads the int8 data (~4x fewer
wire bytes) and dequantizes on the device, on the copy stream, so the
staged buffer is always fp32.

Every job carries the request's transfer epoch; the engine bumps the
epoch on eviction, so completions for a superseded residency generation
are discarded instead of corrupting the accounting.  A copy that raises
is reported as ``ok=False``: the engine counts it and copies
synchronously instead.

On the CPU (tests) the same jobs run with plain tensor copies and no
streams.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from ..models.model import resolve_device

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TransferDone:
    """One completed background copy, as drained by the engine."""
    kind: str                    # "d2h" (offload) | "h2d" (reload staging)
    rid: int
    epoch: int
    n_blocks: int
    seconds: float               # measured wall time of the copy
    blocks: Optional[dict] = None   # d2h only: {logical index -> ndarray}
    ok: bool = True              # False: the copy raised; nothing landed
    quantized: bool = False      # int8 wire: excluded from the t_block
    # EWMA (the copy budget already scales cold copies by COLD_WIRE_RATIO)


def _tensors(gathered) -> tuple:
    return gathered if isinstance(gathered, tuple) else (gathered,)


class TransferWorker:
    """One background thread owning both copy lanes of one engine, on
    ``device`` (the card: its own copy stream; the CPU: plain copies)."""

    def __init__(self, max_staged: int = 2, device="cuda"):
        self.max_staged = max_staged
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._jobs: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._lock = threading.Lock()
        self._done: list[TransferDone] = []
        # rid -> (epoch, n_blocks, (n, L, 2, bs, Hkv, hd) device tensor,
        # staging event or None)
        self._staged: dict[int, tuple] = {}
        # rids with a staging job enqueued but not yet landed: reserves the
        # slot so the engine's per-step hints don't enqueue duplicates
        self._inflight: set[int] = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._warned = False
        self.dequantize_calls = 0    # H2D int8 groups dequantized on device

    # -- engine thread ----------------------------------------------------
    def _ensure_started(self) -> None:
        if self._stop.is_set():
            return
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="kv-transfer", daemon=True)
            self._thread.start()

    def offload(self, rid: int, epoch: int, logical: list[int],
                gathered) -> None:
        """Enqueue a D2H mirror: ``gathered`` is the (n, L, 2, bs, Hkv, hd)
        device snapshot of the blocks (or its ``(int8 vals, scales)``
        pair), already launched on the caller's stream."""
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            for t in _tensors(gathered):
                t.record_stream(self._stream)
        self._ensure_started()
        self._jobs.put(("d2h", rid, epoch, logical, gathered, ready))

    def prefetch(self, rid: int, epoch: int,
                 host_blocks: list[np.ndarray]) -> bool:
        """Enqueue H2D staging of ``host_blocks``; False if the staging
        ring is full or this rid is already staged/in flight."""
        with self._lock:
            if (rid in self._staged or rid in self._inflight
                    or len(self._staged) + len(self._inflight)
                    >= self.max_staged):
                return False
            self._inflight.add(rid)
        self._ensure_started()
        self._jobs.put(("h2d", rid, epoch, list(host_blocks)))
        return True

    def take_staged(self, rid: int, epoch: int):
        """Consume a staged reload buffer: (n_blocks, device tensor) or
        None if absent / stale-epoch.  On the card the caller's stream
        waits on the staging event and owns the buffer from here on."""
        with self._lock:
            got = self._staged.pop(rid, None)
        if got is None or got[0] != epoch:
            return None
        _, n, arr, ready = got
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            arr.record_stream(stream)
        return n, arr

    def invalidate(self, rid: int) -> None:
        with self._lock:
            self._staged.pop(rid, None)

    def discard_stale(self, rid: int, current_epoch: int) -> None:
        """Drop a staged buffer whose epoch is no longer current: a staging
        job that completed AFTER ``invalidate`` would otherwise occupy one
        of the ``max_staged`` slots forever."""
        with self._lock:
            got = self._staged.get(rid)
            if got is not None and got[0] != current_epoch:
                del self._staged[rid]

    def drain(self) -> list[TransferDone]:
        with self._lock:
            out, self._done = self._done, []
        return out

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every enqueued job has executed (tests/benches).
        Uses the queue's unfinished-task count, so a job popped but still
        mid-execution keeps flush waiting."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._jobs.unfinished_tasks == 0:
                return True
            time.sleep(1e-3)
        return False

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._jobs.put(None)
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)

    # -- worker thread ------------------------------------------------------
    def _run(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            job = self._jobs.get()
            if job is None:
                self._jobs.task_done()
                break
            try:
                if self._cuda:
                    # the current stream is per thread: launches and copies
                    # of this job go to the copy stream
                    with torch.cuda.stream(self._stream):
                        self._execute(job)
                else:
                    self._execute(job)
            except Exception:
                # never kill the lane (the engine's synchronous path stays
                # correct) but never swallow silently either: report a
                # failed completion so pending-offload accounting drains
                # and the engine can count it
                if not self._warned:
                    self._warned = True
                    logger.warning("background KV transfer failed; engine "
                                   "falls back to synchronous copies "
                                   "(further failures only counted)",
                                   exc_info=True)
                kind, rid, epoch = job[0], job[1], job[2]
                done = TransferDone(kind, rid, epoch, len(job[3]), 0.0,
                                    ok=False)
                with self._lock:
                    self._inflight.discard(rid)
                    self._done.append(done)
            finally:
                job = None          # drop the snapshot before the next get
                self._jobs.task_done()

    def _to_pinned(self, t: torch.Tensor) -> torch.Tensor:
        """Device -> pinned host copy on the copy stream (not yet
        synchronised); CPU tensors are returned as they are."""
        if not self._cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @staticmethod
    def _unpin(t: torch.Tensor) -> np.ndarray:
        """Pageable numpy copy of a synchronised pinned buffer, so the
        buffer goes back to the pinned allocator's cache for the next job
        (the tier keeps its blocks for long; pinning new memory for each
        job would call cudaHostAlloc every time)."""
        if not t.is_pinned():
            return t.numpy()
        return torch.empty(t.shape, dtype=t.dtype).copy_(t).numpy()

    def _to_device(self, arrays: list) -> torch.Tensor:
        """Stack host arrays and upload them from pinned memory on the copy
        stream."""
        host = torch.from_numpy(np.stack(arrays))
        if not self._cuda:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _sync(self) -> None:
        if self._cuda:
            self._stream.synchronize()

    def _execute(self, job: tuple) -> None:
        kind, rid, epoch = job[0], job[1], job[2]
        if kind == "d2h":
            logical, gathered, ready = job[3], job[4], job[5]
            if ready is not None:
                ready.synchronize()         # the gather itself, not timed
                self._stream.wait_event(ready)
            t0 = time.monotonic()
            quant = isinstance(gathered, tuple)
            pinned = [self._to_pinned(t) for t in _tensors(gathered)]
            self._sync()
            dt = time.monotonic() - t0
            host = [self._unpin(t) for t in pinned]
            if quant:
                # quantized-on-device snapshot: the wire carried int8 vals
                # + per-plane scales (~4x fewer bytes than fp32)
                vals, scales = host
                blocks = {bi: (vals[i], scales[i])
                          for i, bi in enumerate(logical)}
            else:
                blocks = {bi: host[0][i] for i, bi in enumerate(logical)}
            done = TransferDone("d2h", rid, epoch, len(logical), dt,
                                blocks=blocks, quantized=quant)
            with self._lock:
                self._done.append(done)
            return
        host_blocks = job[3]
        t0 = time.monotonic()
        quant = isinstance(host_blocks[0], tuple)
        assert all(isinstance(b, tuple) == quant for b in host_blocks), \
            "a tier group mixes int8 and fp32 payloads"
        if quant:
            # cold-tier group: upload int8 + scales, dequantize on device so
            # the staged buffer is fp32 like any other
            arr = ops.kv_block_dequantize(
                self._to_device([b[0] for b in host_blocks]),
                self._to_device([b[1] for b in host_blocks]))
            self.dequantize_calls += 1
        else:
            arr = self._to_device(host_blocks)
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._sync()
        dt = time.monotonic() - t0
        done = TransferDone("h2d", rid, epoch, len(host_blocks), dt,
                            quantized=quant)
        with self._lock:
            self._inflight.discard(rid)
            self._staged[rid] = (epoch, len(host_blocks), arr, ready)
            self._done.append(done)
