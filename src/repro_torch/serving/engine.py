"""Serving engine: continuous batching over a PyTorch model on the card
(port of ``repro.serving.engine``: the colocated, prefill and decode
roles, and the threaded ``EngineDriver``).

One ``Engine`` = one model replica.  Each iteration:

  1. the policy (``SlideBatching``, the same scheduling core the simulator
     runs) forms a batch against the BlockManager accounting;
  2. eviction and reload directives are applied to the PagedKVPool (host
     mirrors, drops, restores).  With ``overlap_transfers`` (the default)
     the copies run on a background worker (``serving/transfer.py``):
     proactive offloads are enqueued as one-gather snapshots, reloads
     consume pre-staged buffers, and completions feed the BlockManager's
     accounting lanes and the measured ``t_block`` behind the §4.3
     adaptive copy budget.  Without it an evicted request's surviving
     span is copied to host in one gather and one device-to-host copy,
     and a reload is one batched host-to-device scatter.  With
     ``host_tier_bytes`` the host tier is bounded and demotes into an
     int8 cold tier, and prefix-cache evictions spill into it;
  3. prefill chunks run PACKED — every request's chunk in one
     ``prefill_packed`` call (``packed_prefill=False``: one
     ``prefill_chunk`` call per request) — greedy-sampling the first token
     when a prompt completes; decode entries run as one fused
     ``decode_step`` (``fused_decode=False``: ``decode_batch`` on the
     unpadded batch, which returns the logits); on the card the fused
     step is captured into one CUDA graph per batch bucket and replayed
     (``model_exec.DecodeGraphs``).  With ``spec_draft`` and ``spec_k > 0`` a
     ``DraftRunner`` (``serving/spec.py``) proposes up to the planned depth
     per request and ONE ``verify_step`` scores every (request, draft
     position) row; greedy acceptance keeps each stream equal to plain
     decode;
  4. measured wall-clock batch latencies feed the §4.1 estimator, which is
     refit online every ``refit_every`` batches.

Each target model launch that samples costs exactly one device-to-host
fetch (the sampled tokens), counted in ``EngineStats.host_syncs``, as is
each draft decode round; a per-request prefill chunk fetches only when
its prompt completes.

Disaggregation: a ``role="prefill"`` replica exports every request whose
prefill leg is done as a ``HandoffPayload`` (one ``block_gather`` launch
into a fresh tensor, or ``kv_block_quantize`` after it with
``handoff_quantize``, copied to the host on the D2H lane) and releases
its blocks; a ``role="decode"`` replica adopts a payload with
``import_handoff`` (one upload, an on-device dequantize for the int8
wire, one scatter) and continues the decode leg.  The payload travels
through host memory, as in the reference, so it outlives either replica.

Two driving modes:

* synchronous — a caller (tests, ``ServiceController``) invokes ``step()``
  directly and inspects the returned dict;
* threaded — an ``EngineDriver`` owns the engine on its own thread, pulls
  submissions from a per-instance inbox queue, and forwards per-token
  ``TokenEvent``s plus per-step ``StepEvent``s to a sink (the async
  ``ServiceFrontend``).  All engine state is touched only on the driver
  thread, so the engine itself needs no locks.  Every launch of a driver
  thread goes to that thread's current stream, the legacy default stream
  (the kernel wrappers and the transfer lanes read the current stream at
  launch time, on the thread that launches), so replicas on one card
  share one stream and each one's token fetch waits for the other's
  queued launches: exact, and serialized on the device.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs
from ..core.batching import (BatchPlan, EngineConfig, SchedView,
                             evict_for_space, needed_context)
from ..core.blocks import BlockManager, blocks_for
from ..core.estimator import BatchLatencyEstimator
from ..core.request import Phase, Request
from ..kernels import ops
from ..models.model import ArchConfig, resolve_device
from ..models.moe import counting_drops
from . import model_exec
from .kv_pool import PagedKVPool
from .prefix_cache import RadixPrefixCache
from .spec import DraftRunner
from .transfer import TransferWorker

logger = logging.getLogger(__name__)

# the spans of a request's life in the engine (``repro_torch.obs``)
QUEUED, PREFILL, DECODE = "request.queued", "request.prefill", "request.decode"


@dataclass(frozen=True)
class TokenEvent:
    """One token leaving an engine, stamped on the driver thread."""
    rid: int
    token: int
    index: int                   # 1-based output position
    t_wall: float                # time.monotonic() at emission
    first: bool
    last: bool


@dataclass
class HandoffPayload:
    """One finished prefill leaving a prefill-role replica: the request,
    everything needed to resume it (prompt + tokens already streamed), and
    its KV as host-side block payloads — fp32 arrays, or ``(int8 vals,
    fp32 scales)`` pairs when the handoff wire is quantized (the same
    per-(layer, K/V)-plane scheme as the cold tier, dequantized ON DEVICE
    at adoption)."""
    req: Request
    prompt: np.ndarray
    outputs: list            # tokens already emitted (streamed by src)
    kv_tokens: int           # KV extent shipped == needed_context(req)
    payloads: list           # per-block: np.ndarray | (vals, scales)
    quantized: bool
    src_iid: int = -1        # stamped by the caller that picks it up

    @property
    def n_blocks(self) -> int:
        return len(self.payloads)

    @property
    def wire_bytes(self) -> int:
        return sum(b[0].nbytes + b[1].nbytes if isinstance(b, tuple)
                   else b.nbytes for b in self.payloads)


@dataclass(frozen=True)
class HandoffEvent:
    """A prefill replica finished a request's prefill leg: its KV payload
    is ready to be adopted by a decode replica."""
    iid: int                 # source (prefill) instance
    payload: HandoffPayload


@dataclass(frozen=True)
class HandoffAdopted:
    """A decode replica adopted a payload: the decode leg is live there."""
    iid: int                 # adopting (decode) instance
    payload: HandoffPayload


@dataclass(frozen=True)
class HandoffDropped:
    """A decode replica could not adopt a delivered payload (no device
    blocks even after policy eviction) — the router should fail the
    request over to a re-prefill."""
    iid: int                 # target (decode) instance that refused
    payload: HandoffPayload


@dataclass(frozen=True)
class StepEvent:
    """Engine-side summary of one iteration, for router bookkeeping."""
    iid: int
    free_blocks: int
    latency: float
    est_time: float
    prefill_done: tuple = ()     # rids whose first token just came out
    finished: tuple = ()         # rids fully generated this step


@dataclass(frozen=True)
class DriverFailed:
    """A driver thread raised: its engine is dead, and every request it
    held must be failed (the frontend closes their streams with
    ``error``).  Not in the reference, whose driver thread dies
    silently."""
    iid: int
    error: BaseException


class DriverDied(RuntimeError):
    """Raised by ``EngineDriver.join_idle`` / ``stop`` (and the frontend's
    ``drain`` / ``stop``) when a driver thread raised; the thread's
    exception is the ``__cause__``."""


@dataclass
class EngineStats:
    iterations: int = 0
    tokens_out: int = 0
    prefill_tokens: int = 0
    evictions: int = 0
    reload_blocks: int = 0
    cache_hit_tokens: int = 0      # prompt tokens served from the prefix cache
    cache_insert_blocks: int = 0   # blocks adopted into the prefix cache
    cow_forks: int = 0             # copy-on-write forks of shared blocks
    packed_prefill_calls: int = 0  # batched multi-request prefill launches
    offload_blocks: int = 0        # async D2H blocks landed on host
    staged_hits: int = 0           # reloads served from pre-staged buffers
    staged_misses: int = 0         # reloads that fell back to a sync copy
    transfer_wait_s: float = 0.0   # total step time stalled on sync copies
    transfer_failures: int = 0     # background copies that raised (fell
    # back to the synchronous path; the first one is logged by the worker)
    t_block_measured: float = 0.0  # EWMA per-block copy time (closed loop)
    # cumulative background-lane copies, per direction (the copy time the
    # worker measures, and the blocks it moved, stale completions included)
    d2h_copy_s: float = 0.0
    d2h_copy_blocks: int = 0
    h2d_copy_s: float = 0.0
    h2d_copy_blocks: int = 0
    refit_failures: int = 0        # online estimator refits that failed
    decode_launches: int = 0       # decode_step calls (one per step with
    # decode work)
    decode_graph_captures: int = 0  # fused decode steps run eagerly and
    # then captured into their batch bucket's CUDA graph
    decode_graph_replays: int = 0  # fused decode steps run as one replay
    host_bytes: int = 0            # current hot host-tier bytes (<= budget)
    spill_blocks: int = 0          # cumulative prefix-cache blocks spilled
    # to the host tier instead of destroyed (tiered KV cache)
    cold_blocks: int = 0           # current int8 cold-tier blocks
    host_syncs: int = 0            # device->host fetches in the hot loop —
    # exactly one per sampling launch (no hidden syncs)
    prefill_chunk_calls: int = 0   # per-request prefill_chunk launches
    # (packed_prefill=False)
    # --- disaggregation (prefill/decode split) ---------------------------
    handoffs_out: int = 0          # prefill legs exported to a decode peer
    handoff_blocks_out: int = 0    # KV blocks shipped out
    handoff_bytes_out: int = 0     # wire bytes shipped out (int8 < fp32)
    handoffs_in: int = 0           # payloads adopted from a prefill peer
    handoff_blocks_in: int = 0     # KV blocks adopted
    handoff_bytes_in: int = 0      # wire bytes adopted
    handoff_copy_s: float = 0.0    # worker time on handoff D2H copies
    # --- speculative decoding (draft propose + packed verify) ------------
    spec_proposed: int = 0         # draft tokens proposed for verification
    spec_accepted: int = 0         # proposals matching the target argmax
    spec_rejected: int = 0         # proposals refuted (== proposed - accepted)
    draft_launches: int = 0        # draft-model calls (prefill + rounds)
    spec_depth_hist: dict = field(default_factory=dict)  # depth -> entries
    busy_s: float = 0.0            # host time of the steps that formed a
    # batch, from the plan's first copy to the last token emitted
    # --- routed experts (MoE models; 0 otherwise) --------------------------
    moe_routed_slots: int = 0      # slots the model calls' real tokens
    # routed (tokens x top_k, summed over the layers; model_exec.moe_work)
    moe_expert_rows: int = 0       # rows the expert GEMMs computed (E x C x
    # batch rows, padding included, summed over the layers)
    # the device counter of the slots dropped past capacity, which the
    # model calls (graph replays included) add to on the device
    moe_dropped: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def moe_dropped_slots(self) -> int:
        """Routed slots dropped past capacity since the engine started,
        read from the device counter (one device sync, here only)."""
        return 0 if self.moe_dropped is None else int(self.moe_dropped)

    def count_moe(self, work: dict) -> None:
        """Add one model call's ``model_exec.moe_work``."""
        if work:
            self.moe_routed_slots += work["moe_routed"]
            self.moe_expert_rows += work["moe_rows"]


class Engine:
    def __init__(self, cfg: ArchConfig, params: dict, eng_cfg: EngineConfig,
                 policy, *, num_blocks: int = 512, block_size: int = 16,
                 t_block: float = 5e-4, max_ctx: int = 1024,
                 est: Optional[BatchLatencyEstimator] = None,
                 bm_kwargs: Optional[dict] = None,
                 prefix_cache: bool = True,
                 cache_blocks: Optional[int] = None,
                 packed_prefill: bool = True,
                 overlap_transfers: bool = True,
                 fused_decode: bool = True,
                 host_tier_bytes: Optional[int] = None,
                 cold_quantize: bool = True,
                 role: str = "coloc",
                 handoff_quantize: bool = False,
                 spec_draft: Optional[tuple] = None,
                 spec_draft_blocks: Optional[int] = None,
                 device="cuda"):
        """``params`` (and a draft's) must already live on ``device``
        (default the card; ``device="cpu"`` runs the plain PyTorch kernel
        versions).  Replicas may share one ``params`` dict."""
        if role not in ("coloc", "prefill", "decode"):
            raise ValueError(f"unknown engine role: {role!r}")
        if eng_cfg.spec_k > 0 and spec_draft is None:
            raise ValueError("spec_k > 0 requires spec_draft=(cfg, params)")
        model_exec.require_paged(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        # a role-parameterized replica runs the same pipeline; the role
        # only (a) flips the policy's pd_mode (prefill replicas price
        # admission with the prefill-phase phi), (b) arms the handoff
        # export path (prefill) / import path (decode)
        self.role = role
        if role != "coloc" and eng_cfg.pd_mode != role:
            eng_cfg = dataclasses.replace(eng_cfg, pd_mode=role)
        self.eng_cfg = eng_cfg
        # int8 handoff wire: quantize the exported KV on device (the cold
        # tier's kernel pair) so the cross-replica copy is ~4x narrower;
        # lossy-but-deterministic (|x - deq| <= scale/2 per plane)
        self.handoff_quantize = handoff_quantize
        self.policy = policy
        self.max_ctx = max_ctx
        # host_tier_bytes bounds the hot host tier (LRU demotion into the
        # int8 cold tier, see kv_pool.KVTierStore); None = unbounded host
        # mirror with bitwise-identical token streams
        self.pool = PagedKVPool(cfg, num_blocks, block_size,
                                dtype=params["embed"].dtype,
                                device=self.device,
                                host_tier_bytes=host_tier_bytes,
                                cold_quantize=cold_quantize)
        self.bm = BlockManager(num_blocks - 1, block_size, t_block,
                               **(bm_kwargs or {}))
        # radix prefix cache: shares prompt KV across requests (refcounted
        # blocks, CoW); holds at most ``cache_blocks`` beyond live pins and
        # yields them back on demand (BlockManager.reclaim_cache).  With a
        # bounded host tier, evictions SPILL into it instead of destroying
        # the KV (restorable on a later match).
        self.cache: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.pool, self.bm, max_blocks=cache_blocks,
                             spill=host_tier_bytes is not None)
            if prefix_cache else None)
        self.packed_prefill = packed_prefill
        # fused decode: argmax on device, batch and table padded to shape
        # buckets; the logits path (decode_batch) is kept for equivalence
        self.fused_decode = fused_decode
        # speculative decoding: a draft replica proposes, the target packs
        # all (request, position) rows into ONE verify_step launch; greedy
        # acceptance keeps streams equal to plain decode
        self.draft: Optional[DraftRunner] = None
        if spec_draft is not None and eng_cfg.spec_k > 0:
            dcfg, dparams = spec_draft
            if dparams["embed"].device.type != self.device.type:
                raise ValueError(f"draft params are on "
                                 f"{dparams['embed'].device}, the engine "
                                 f"on {self.device}")
            self.draft = DraftRunner(
                dcfg, dparams, num_blocks=spec_draft_blocks or num_blocks,
                block_size=block_size, max_ctx=max_ctx,
                dtype=params["embed"].dtype, device=self.device)
        # the fused decode on the card: one CUDA graph per batch bucket,
        # at one table width that starts at max_ctx's blocks (the draft
        # and the verify step stay eager, as does every CPU engine)
        self.graphs: Optional[model_exec.DecodeGraphs] = (
            model_exec.DecodeGraphs(
                cfg, params, model_exec.table_bucket(-(-max_ctx
                                                       // block_size)),
                self.device)
            if fused_decode and self.draft is None
            and self.device.type == "cuda" else None)
        self.worker: Optional[TransferWorker] = (
            TransferWorker(device=self.device) if overlap_transfers
            else None)
        if self.cache is not None:
            # spill restores prefer buffers the worker pre-staged
            self.cache.worker = self.worker
        # per-rid transfer epoch: bumped on evict so background completions
        # for a superseded residency generation are discarded
        self._epoch: dict[int, int] = {}
        # proactive-offload directives recorded during form_batch (the K/V
        # they name is only fully written once the step's exec completes)
        self._offload_directives: list[tuple[int, int, int, int]] = []
        if self.worker is not None:
            self.bm.external_lanes = True
            self.bm.offload_sink = self._note_offload_directive
        self.est = est or BatchLatencyEstimator(
            a_p=1e-8, b_p=1e-8, c_p=1e-5, a_d=1e-8, b_d=1e-4, t_c=1e-3)
        # full token sequence (prompt + outputs) per request, appended
        # incrementally — avoids the per-chunk prompt+outputs rebuild
        self._seqs: dict[int, np.ndarray] = {}
        self._seq_fill: dict[int, int] = {}
        # prefill-role export state: payloads whose D2H copy is riding the
        # background lane (rid -> payload, the device snapshot it copies
        # (kept for the failure path), epoch), and completed payloads
        # awaiting pickup by the controller
        self._handoff_wait: dict[int, tuple[HandoffPayload, object, int]] = {}
        self._handoff_ready: list[HandoffPayload] = []
        self.queue: list[Request] = []
        self.now = 0.0
        # when set, ``now`` tracks wall time relative to a shared epoch
        self._wall_epoch: Optional[float] = None
        self.stats = EngineStats()
        if cfg.family == "moe":
            self.stats.moe_dropped = torch.zeros((), dtype=torch.int64,
                                                 device=self.device)
        self._profile: list[tuple[list, float]] = []
        self.refit_every = 50
        self.alive = True
        self.outputs: dict[int, list[int]] = {}
        # while the recorder is on: rid -> (the ``request.*`` span the
        # request is in, its start on time.monotonic())
        self._t_req: dict[int, tuple[str, float]] = {}
        # streaming hook: called as on_token(req, tok, first, last) at the
        # instant of emission
        self.on_token: Optional[Callable[[Request, int, bool, bool],
                                         None]] = None

    # ------------------------------------------------------------------
    def add_request(self, req: Request, prompt_tokens: np.ndarray,
                    prior_outputs: Optional[list[int]] = None) -> None:
        """``prior_outputs``: tokens already streamed to the client before a
        failover — the engine resumes mid-generation by recomputing their
        KV (they are ordinary known tokens) and continuing exactly."""
        req.instance = id(self) & 0xffff
        if obs.recorder().enabled:
            self._t_req[req.rid] = (QUEUED, time.monotonic())
        self.queue.append(req)
        self.outputs[req.rid] = list(prior_outputs or [])
        prompt = np.asarray(prompt_tokens, np.int32)
        req._prompt = prompt  # type: ignore
        prior = self.outputs[req.rid]
        seq = np.zeros(len(prompt) + max(req.output_len, len(prior)) + 1,
                       np.int32)
        seq[:len(prompt)] = prompt
        if prior:
            seq[len(prompt):len(prompt) + len(prior)] = prior
        self._seqs[req.rid] = seq
        self._seq_fill[req.rid] = len(prompt) + len(prior)
        if self.cache is not None:
            hit, blocks = self.cache.match(prompt, self.now, req.rid,
                                           req.weight)
            req.prefilled = hit
            if hit:
                # point the table at the cached blocks; only the uncached
                # suffix remains as (chunked) prefill work
                self.pool.share(req.rid, blocks)
                self.bm.attach_cached(req, hit)
                self.stats.cache_hit_tokens += hit

    def has_work(self) -> bool:
        return (any(r.phase != Phase.FINISHED for r in self.queue)
                or bool(self._handoff_wait) or bool(self._handoff_ready))

    # ------------------------------------------------------------------
    # §4.3 transfer lanes (background worker plumbing)
    # ------------------------------------------------------------------
    def _note_offload_directive(self, rid: int, start: int, n: int) -> None:
        """BlockManager offload_sink: a proactive D2H mirror was scheduled
        during form_batch.  The blocks' K/V is only written once this
        step's exec completes, so just record the directive; the device
        snapshot happens in ``_dispatch_offloads``."""
        self._offload_directives.append(
            (rid, start, n, self._epoch.get(rid, 0)))

    def _dispatch_offloads(self) -> int:
        """Snapshot each recorded directive's blocks (one device gather)
        and hand them to the background D2H lane; returns the blocks."""
        directives, self._offload_directives = self._offload_directives, []
        if self.worker is None:
            return 0
        sent = 0
        for rid, start, n, epoch in directives:
            if epoch != self._epoch.get(rid, 0):
                continue            # evicted since the directive
            t = self.pool.tables.get(rid)
            if not t:
                continue
            logical = [bi for bi in range(start, start + n) if bi < len(t)]
            if not logical:
                continue
            if self.pool.tier.prefer_cold(len(logical)):
                # this mirror would land demote-bound in the cold tier:
                # quantize on device so the D2H wire is int8 (~4x less)
                gathered = self.pool.gather_blocks_quantized(rid, logical)
            else:
                gathered = self.pool.gather_blocks(rid, logical)
            self.worker.offload(rid, epoch, logical, gathered)
            sent += len(logical)
        return sent

    def _drain_transfers(self) -> int:
        """Collect background-copy completions; feed the accounting lanes
        (real transfers replace the virtual clock) and the measured-
        throughput side of the adaptive copy budget."""
        if self.worker is None:
            return 0
        landed = 0
        st = self.stats
        for d in self.worker.drain():
            if d.ok and d.kind == "d2h":
                st.d2h_copy_s += d.seconds
                st.d2h_copy_blocks += d.n_blocks
            elif d.ok:
                st.h2d_copy_s += d.seconds
                st.h2d_copy_blocks += d.n_blocks
            if d.kind == "d2h" and d.rid in self._handoff_wait:
                # handoff export riding the D2H lane: the local leg is
                # already released, so this must be intercepted BEFORE the
                # stale/dead guards.  Failure falls back to a synchronous
                # fetch of the retained device snapshot (a fresh tensor
                # the pool never writes, so still intact)
                payload, gathered, epoch = self._handoff_wait[d.rid]
                if d.epoch == epoch:
                    del self._handoff_wait[d.rid]
                    self._epoch.pop(d.rid, None)
                    self.stats.handoff_copy_s += d.seconds
                    if d.ok:
                        payload.payloads = [d.blocks[bi]
                                            for bi in sorted(d.blocks)]
                    else:
                        self.stats.transfer_failures += 1
                        payload.payloads = self._materialize_handoff(
                            gathered, payload.quantized)
                    self._finalize_handoff(payload)
                continue
            stale = d.epoch != self._epoch.get(d.rid, 0)
            dead = d.rid not in self.bm.table
            if d.kind == "h2d":
                # a staging buffer that can no longer be consumed would pin
                # one of the double-buffer slots forever: job finished after
                # invalidate() (stale), after the request was released
                # (dead), or after the reload it was staged for already ran
                # synchronously (nothing left on host to restore)
                if d.rid < 0:
                    # radix-cache spill pseudo-rid: never in bm.table, so
                    # ask the cache whether the spilled group still exists
                    # (restore consumes the buffer; re-adoption/prune
                    # invalidates it)
                    if (self.cache is None
                            or not self.cache.has_spilled(d.rid)):
                        self.worker.invalidate(d.rid)
                    continue
                s = self.bm.table.get(d.rid)
                if dead or (s is not None and s.host_tokens == 0):
                    self.worker.invalidate(d.rid)
                elif stale:
                    self.worker.discard_stale(d.rid,
                                              self._epoch.get(d.rid, 0))
            if stale:
                continue
            if not d.ok:
                self.stats.transfer_failures += 1
                if d.kind == "d2h":
                    # release the pending claim; mirroring retries later
                    self.bm.note_offload_failed(d.rid, d.n_blocks)
                continue
            if d.kind == "d2h" and d.rid in self.bm.table:
                self.pool.host_store(d.rid, d.blocks)
                self.bm.note_offload_complete(d.rid, d.n_blocks)
                self.stats.offload_blocks += d.n_blocks
                landed += d.n_blocks
            if not d.quantized:
                # int8-wire copies are excluded: the copy budget scales
                # them by COLD_WIRE_RATIO on top of the fp32 t_block, so
                # folding their samples in would count the 4x twice
                self.bm.observe_transfer(d.n_blocks, d.seconds)
                self.stats.t_block_measured = self.bm.t_block
        return landed

    def _prefetch_reloads(self) -> int:
        """Hint the H2D staging lane: evicted requests near the head of the
        (policy-sorted) queue will likely reload next round, so stage their
        host blocks now and the copy lands before the batch that needs
        it.  Payloads go out in tier wire format: cold groups ship int8 and
        the worker dequantizes on device.  Leftover slots stage the most
        recently touched radix-cache spill groups.  Returns the groups
        staged."""
        if self.worker is None:
            return 0
        hinted = 0
        for r in self.queue:
            if hinted >= self.worker.max_staged:
                break
            s = self.bm.table.get(r.rid)
            if s is None or s.host_tokens <= 0 or s.dev_tokens > 0:
                continue
            nb = blocks_for(s.host_tokens, self.bm.block_size)
            payloads = self.pool.tier.payloads(r.rid, range(nb))
            if payloads is None:
                continue
            if self.worker.prefetch(r.rid, self._epoch.get(r.rid, 0),
                                    payloads):
                hinted += 1
        if self.cache is not None and hinted < self.worker.max_staged:
            for host_rid, payloads in self.cache.spill_candidates(
                    self.worker.max_staged - hinted):
                if self.worker.prefetch(host_rid, 0, payloads):
                    hinted += 1
        return hinted

    def _forget_transfers(self, rid: int) -> None:
        """Invalidate all in-flight transfer state for rid (eviction)."""
        self._epoch[rid] = self._epoch.get(rid, 0) + 1
        if self.worker is not None:
            self.worker.invalidate(rid)

    def _sync_tier_state(self) -> None:
        """Mirror the tier store into the scheduling layer: mark each live
        request's host span cold when its tier group was demoted (the
        copy-budget control then prices its reload at the int8 wire), and
        refresh the tier gauges on EngineStats.  With an unbounded host
        tier nothing is ever cold and this is a no-op on the accounting."""
        tier = self.pool.tier
        if tier.budget_bytes is not None:
            for rid, s in self.bm.table.items():
                s.cold_tokens = (s.host_tokens if tier.is_cold(rid) else 0)
        self.stats.host_bytes = tier.host_bytes
        self.stats.cold_blocks = tier.cold_blocks
        if self.cache is not None:
            self.stats.spill_blocks = self.cache.stats.spilled_blocks

    def _evict_to_host(self, r: Request) -> None:
        """Apply one (already accounted) eviction to the data layer: the
        surviving span must be on host.  With overlap the async mirror
        already landed (mirrored_blocks only counts real completions);
        otherwise copy the missing blocks now, in one batched device
        fetch.  Then drop the device references."""
        s = self.bm.state(r)
        keep_blocks = blocks_for(s.host_tokens, self.bm.block_size)
        if keep_blocks:
            missing = [bi for bi in range(keep_blocks)
                       if not self.pool.tier.has_block(r.rid, bi)]
            self.pool.offload_blocks(r.rid, missing)
        self.pool.drop_device_blocks(r.rid)
        self._forget_transfers(r.rid)
        if self.draft is not None:
            self.draft.drop(r.rid)
        self.stats.evictions += 1

    def _sync_pool_with_bm(self, plan: BatchPlan) -> None:
        """Apply the §4.3 directives the policy issued on the accounting
        layer (BlockManager) to the actual data (PagedKVPool)."""
        for r in plan.evictions:
            self._evict_to_host(r)

    # ------------------------------------------------------------------
    # disaggregation: prefill -> decode KV handoff
    # ------------------------------------------------------------------
    @staticmethod
    def _materialize_handoff(gathered, quantized: bool) -> list:
        """Synchronous fetch of a handoff snapshot into per-block host
        payloads (the no-worker path, and the failure fallback)."""
        if quantized:
            vals, scales = (t.cpu().numpy() for t in gathered)
            return [(vals[i], scales[i]) for i in range(vals.shape[0])]
        data = gathered.cpu().numpy()
        return [data[i] for i in range(data.shape[0])]

    def _finalize_handoff(self, payload: HandoffPayload) -> None:
        self.stats.handoffs_out += 1
        self.stats.handoff_blocks_out += payload.n_blocks
        self.stats.handoff_bytes_out += payload.wire_bytes
        self._handoff_ready.append(payload)

    def _collect_handoffs(self) -> None:
        """Prefill role: any queued request whose prefill leg is complete
        (first token emitted — or a failover recompute caught up — and the
        KV fully device-resident) is exported.  Runs before form_batch so
        an export-ready request is never decoded locally, and again after
        the step so the common case (prefill finished this iteration)
        ships without an extra scheduling round."""
        ready = []
        for r in self.queue:
            if r.phase != Phase.DECODE:
                continue        # output_len == 1 finishes on this replica
            s = self.bm.table.get(r.rid)
            if s is None or s.dev_tokens < needed_context(r):
                continue
            ready.append(r)
        for r in ready:
            self._export_handoff(r)

    def _export_handoff(self, r: Request) -> None:
        rid = r.rid
        kv_tokens = needed_context(r)
        nb = blocks_for(kv_tokens, self.pool.block_size)
        logical = list(range(nb))
        payload = HandoffPayload(
            req=r, prompt=np.asarray(r._prompt, np.int32),  # type: ignore
            outputs=list(self.outputs.get(rid, [])),
            kv_tokens=kv_tokens, payloads=[],
            quantized=self.handoff_quantize)
        # ONE device gather (quantized on device when the wire is int8)
        # into a fresh tensor: later in-place pool writes into the blocks
        # released below run after it on the engine's stream, and the
        # worker's copy waits on its ready event, so the snapshot is
        # race-free and the local blocks can be released immediately
        gathered = (self.pool.gather_blocks_quantized(rid, logical)
                    if self.handoff_quantize
                    else self.pool.gather_blocks(rid, logical))
        epoch = self._epoch.get(rid, 0) + 1
        self._epoch[rid] = epoch
        if self.worker is not None:
            self._handoff_wait[rid] = (payload, gathered, epoch)
            self.worker.offload(rid, epoch, logical, gathered)
        # release the local leg — the decode replica owns the request now
        self.bm.release(r)
        self.pool.release(rid)
        if self.worker is not None:
            self.worker.invalidate(rid)
        self.outputs.pop(rid, None)
        self._seqs.pop(rid, None)
        self._seq_fill.pop(rid, None)
        self._t_req.pop(rid, None)
        if self.draft is not None:
            self.draft.drop(rid)
        self.queue = [q for q in self.queue if q.rid != rid]
        r.instance = None
        if self.worker is None:
            self._epoch.pop(rid, None)
            payload.payloads = self._materialize_handoff(
                gathered, payload.quantized)
            self._finalize_handoff(payload)

    def take_handoffs(self) -> list[HandoffPayload]:
        """Completed handoff payloads since the last call (the controller
        picks these up after each step and routes them)."""
        out, self._handoff_ready = self._handoff_ready, []
        return out

    def handoff_outputs(self, rid: int) -> Optional[list[int]]:
        """Streamed tokens of a request currently in handoff-export state.

        ``_export_handoff`` pops ``self.outputs[rid]`` the moment the KV
        snapshot is taken, so a caller mirroring outputs into a durable
        log after the step would otherwise miss the prefill leg's first
        token — and a failover resume from that log would drop it.  The
        payload keeps the authoritative copy until delivery."""
        ent = self._handoff_wait.get(rid)
        if ent is not None:
            return list(ent[0].outputs)
        for p in self._handoff_ready:
            if p.req.rid == rid:
                return list(p.outputs)
        return None

    def import_handoff(self, payload: HandoffPayload) -> bool:
        """Decode side: adopt a prefill peer's KV payload and continue the
        decode leg exactly where the source stopped.  All blocks land in
        ONE batched scatter; int8 wire payloads are uploaded as int8 and
        dequantized ON DEVICE (one ``kv_block_dequantize`` call, counted
        in the pool's ``dequantize_calls``).  Returns False if device
        blocks could not be made available (the caller should fail over
        to a re-prefill)."""
        req, rid = payload.req, payload.req.rid
        nb = len(payload.payloads)
        ok = self.bm.grow(req, payload.kv_tokens, self.now)
        if not ok:
            # the admission-time reservation should make this impossible;
            # evict per policy (mirrors EngineSim.import_request)
            view = SchedView(self.queue, self.bm, self.est, self.eng_cfg,
                             self.now)
            need = self.bm.blocks_needed_for_growth(req, payload.kv_tokens)
            for v in evict_for_space(view, need, {rid}):
                self._evict_to_host(v)
            ok = self.bm.grow(req, payload.kv_tokens, self.now)
        if not ok or not self.pool.alloc(rid, nb):
            self.bm.release(req)
            self.pool.release(rid)
            return False
        entries = payload.payloads
        if entries and all(isinstance(e, tuple) for e in entries):
            data = ops.kv_block_dequantize(
                self._dev(np.stack([e[0] for e in entries])),
                self._dev(np.stack([e[1] for e in entries])))
            self.pool.dequantize_calls += 1
        else:
            data = self._dev(np.stack(entries))
        self.pool._scatter(self.pool.tables[rid], data)
        req.instance = id(self) & 0xffff
        if obs.recorder().enabled:
            self._t_req[rid] = (QUEUED, time.monotonic())
        self.queue.append(req)
        self.outputs[rid] = list(payload.outputs)
        prompt = np.asarray(payload.prompt, np.int32)
        req._prompt = prompt  # type: ignore
        prior = payload.outputs
        seq = np.zeros(len(prompt) + max(req.output_len, len(prior)) + 1,
                       np.int32)
        seq[:len(prompt)] = prompt
        if prior:
            seq[len(prompt):len(prompt) + len(prior)] = prior
        self._seqs[rid] = seq
        self._seq_fill[rid] = len(prompt) + len(prior)
        self.stats.handoffs_in += 1
        self.stats.handoff_blocks_in += nb
        self.stats.handoff_bytes_in += payload.wire_bytes
        return True

    def use_wall_clock(self, epoch: float) -> None:
        """Drive ``now`` from ``time.monotonic() - epoch`` (shared across
        replicas) instead of the per-engine virtual latency accumulator."""
        self._wall_epoch = epoch
        self.now = max(self.now, time.monotonic() - epoch)

    def step(self) -> Optional[dict]:
        # a step that finds nothing queued records nothing: an idle
        # engine's driver steps it after every park (2 ms), which would
        # fill the recorder's ring in half a minute
        on = obs.recorder().enabled and bool(self.queue)
        span = obs.span if on else obs.quiet
        with span("engine.step") as sp:
            if not self.alive:
                return None
            t_step = (time.monotonic()
                      if on or self._wall_epoch is not None else 0.0)
            if self._wall_epoch is not None:
                self.now = max(self.now, t_step - self._wall_epoch)
            with span("engine.transfers") as tr:
                tr.set(blocks=self._drain_transfers())
                self.bm.complete_offloads(self.now)
                self._sync_tier_state()
                if self.role == "prefill":
                    # straggler exports (e.g. a full-prompt cache hit made
                    # the request decode-ready without any prefill work this
                    # step) — and keeps export-ready requests out of the
                    # local batch
                    self._collect_handoffs()
            view = SchedView(self.queue, self.bm, self.est, self.eng_cfg,
                             self.now)
            t_form = time.monotonic() if on else 0.0
            plan = self.policy.form_batch(view)
            if on:
                # stamped tight around the policy's call: its attributes
                # are gathered after the end
                obs.record("sched.form_batch", t_form, time.monotonic(),
                           entries=len(plan.entries),
                           queued=len(self.queue), t_budget=plan.t_budget,
                           t_c=self.est.t_c, reason=plan.idle_reason)
            if not plan.entries:
                # evictions can outlive a failed admission round: keep the
                # pool consistent with the accounting before going idle,
                # and use the idle gap to stage likely reloads
                if plan.evictions:
                    self._sync_pool_with_bm(plan)
                self._offload_directives.clear()
                with span("engine.prefetch") as pf:
                    pf.set(groups=self._prefetch_reloads())
                return None
            if on:
                for e in plan.entries:
                    self._note_scheduled(e.req, t_step)
            t0 = time.monotonic()
            with span("engine.reload") as rl:
                self._sync_pool_with_bm(plan)
                step_reload = self._reload(plan)
                rl.set(blocks=step_reload, evictions=len(plan.evictions))

            decode_entries = [e for e in plan.entries if not e.is_prefill]
            prefill_entries = [e for e in plan.entries if e.is_prefill]
            if on:
                sp.set(rows=len(plan.entries),
                       tokens=sum(e.n_tokens for e in prefill_entries))
            emitted: list[Request] = []
            t_capture = 0.0
            # a routed model's layers count their dropped slots on the
            # device (a MoE draft's too)
            with counting_drops(self.stats.moe_dropped):
                if prefill_entries:
                    if self.packed_prefill:
                        self._run_prefill_packed(prefill_entries, emitted)
                    else:
                        self._run_prefill_fallback(prefill_entries, emitted)
                if decode_entries:
                    if self.draft is not None:
                        self._run_decode_spec(decode_entries, emitted)
                    else:
                        t_capture = self._run_decode(decode_entries, emitted)

            latency = time.monotonic() - t0
            if self._wall_epoch is not None:
                self.now = max(self.now, time.monotonic() - self._wall_epoch)
            else:
                self.now += latency
            self.stats.iterations += 1
            self.stats.busy_s += latency
            # a graph's capture is set-up, not the batch's latency
            self._profile.append((plan.work_items(), latency - t_capture))
            if len(self._profile) >= self.refit_every:
                with span("engine.refit") as rf:
                    self._refit()
                    rf.set(t_c=self.est.t_c)

            with span("engine.release") as rs:
                finished = [r for r in self.queue
                            if r.phase == Phase.FINISHED]
                for r in finished:
                    self._release(r)
                self.queue = [r for r in self.queue
                              if r.phase != Phase.FINISHED]
                if self.role == "prefill":
                    # export every request whose prefill leg just completed
                    # (the gather runs before the proactive-mirror dispatch
                    # below, so the exported KV ships exactly once)
                    self._collect_handoffs()
                rs.set(requests=len(finished))
            # all K/V written and finished requests released: snapshot and
            # enqueue the proactive D2H mirrors the policy scheduled
            # (released requests' directives drop out via their empty
            # tables), then stage likely reloads
            with span("engine.offloads") as of:
                of.set(blocks=self._dispatch_offloads())
            with span("engine.prefetch") as pf:
                pf.set(groups=self._prefetch_reloads())
            return {"emitted": emitted, "finished": finished,
                    "latency": latency, "plan": plan}

    def _note_scheduled(self, r: Request, t_step: float) -> None:
        """A request in this step's plan: the first plan that holds it
        ends its wait in the queue and starts its prefill."""
        at = self._t_req.get(r.rid)
        if at is not None and at[0] == QUEUED:
            obs.record(QUEUED, at[1], t_step, rid=r.rid,
                       hit=int(r.prefilled))
            self._t_req[r.rid] = (PREFILL, t_step)

    def _reload(self, plan: BatchPlan) -> int:
        """Reload data for requests whose plan restored host blocks; prefer
        the background lane's pre-staged buffers (the H2D copy already
        landed), falling back to a synchronous batched copy.  Returns the
        blocks restored."""
        step_reload, step_wait = 0, 0.0
        for e in plan.entries:
            s = self.bm.state(e.req)
            hb = self.pool.host_blocks(e.req.rid)
            dev_blocks_needed = blocks_for(s.dev_tokens, self.bm.block_size)
            have = len(self.pool.tables.get(e.req.rid, []))
            # only copy what apply_reload promised (restore_pending): host
            # entries also exist for live device-resident requests, so
            # ``hb > 0`` alone would trigger phantom reloads
            if s.restore_pending > 0 and have < dev_blocks_needed and hb:
                n = min(s.restore_pending, dev_blocks_needed - have)
                s.restore_pending = 0
                staged = (self.worker.take_staged(
                    e.req.rid, self._epoch.get(e.req.rid, 0))
                    if self.worker is not None else None)
                if staged is not None and staged[0] > 0:
                    # ``n`` also counts blocks this step will write fresh
                    # (grown chunk/decode tokens); the staged buffer covers
                    # exactly the restorable host prefix: consume what it
                    # has, the rest is new capacity allocated at exec time
                    # (as reload_blocks stops at the first non-host block)
                    self.pool.reload_from_device(e.req.rid, staged[1],
                                                 min(n, staged[0]))
                    self.stats.staged_hits += 1
                else:
                    tr0 = time.monotonic()
                    self.pool.reload_blocks(e.req.rid, n)
                    step_wait += time.monotonic() - tr0
                    if self.worker is not None:
                        self.stats.staged_misses += 1
                self.stats.reload_blocks += n
                step_reload += n
        self.stats.transfer_wait_s += step_wait
        return step_reload

    def _release(self, r: Request) -> None:
        """Free a finished request's blocks and per-request state."""
        self.bm.release(r)
        self.pool.release(r.rid)
        if self.draft is not None:
            self.draft.drop(r.rid)
        # drop all per-request transfer state: a late completion for this
        # rid is caught by the dead-request guard in _drain_transfers (rid
        # no longer in bm.table)
        if self.worker is not None:
            self.worker.invalidate(r.rid)
        self._epoch.pop(r.rid, None)
        self._seqs.pop(r.rid, None)
        self._seq_fill.pop(r.rid, None)
        self._t_req.pop(r.rid, None)

    # ------------------------------------------------------------------
    # decode execution
    # ------------------------------------------------------------------
    def _run_decode(self, decode_entries: list, emitted: list) -> float:
        """Plain decode: one token per request in one launch.  Fused: the
        batch and table padded to shape buckets (extra rows: token 0,
        len 0, null-block table); on the card the graph of the batch
        bucket replays at the graphs' table width, and a bucket without
        one runs eagerly and is captured.  Otherwise ``decode_batch`` on
        the exact batch returns the (B, V) logits.  Either way only the
        (B,) argmax comes back to the host.  Returns the seconds spent
        capturing."""
        rids = [e.req.rid for e in decode_entries]
        nb = len(decode_entries)
        graphs = self.graphs
        with obs.span("model_exec.prep", kind="decode"):
            for e in decode_entries:
                self.pool.ensure_capacity(e.req.rid, e.l_kv + 1)
                if self.pool.ensure_writable(e.req.rid,
                                             e.l_kv // self.pool.block_size):
                    self.bm.note_fork(e.req)
                    self.stats.cow_forks += 1
            maxp = max(len(self.pool.tables[r]) for r in rids)
            # fused: padded to shape buckets; otherwise the exact batch
            b_b = model_exec.seg_bucket(nb) if self.fused_decode else nb
            if graphs is not None:
                maxp = graphs.fit(maxp)
            elif self.fused_decode:
                maxp = model_exec.table_bucket(maxp)
            lens = np.zeros(b_b, np.int32)
            lens[:nb] = [e.l_kv for e in decode_entries]
            last = np.zeros(b_b, np.int32)
            last[:nb] = [self._last_token(e.req) for e in decode_entries]
            table = self.pool.table_rows(rids, maxp=maxp, rows=b_b)
        with obs.span("model_exec.upload", kind="decode"):
            if graphs is not None:
                graphs.upload(last, table, lens)
            else:
                last, table, lens = (self._dev(a)
                                     for a in (last, table, lens))
        replay = graphs is not None and graphs.ready(b_b, self.pool.kv)
        work = model_exec.moe_work(self.cfg, b_b, 1, nb)
        self.stats.count_moe(work)
        with obs.span("model_exec.launch", kind="decode", rows=nb,
                      tokens=nb, graph=int(replay), **work):
            if replay:
                toks = graphs.replay(b_b)
            elif graphs is not None:
                toks = graphs.warm(b_b, self.pool.kv)
            elif self.fused_decode:
                toks, self.pool.kv = model_exec.decode_step(
                    self.cfg, self.params, self.pool.kv, last, table, lens)
            else:
                logits, self.pool.kv = model_exec.decode_batch(
                    self.cfg, self.params, self.pool.kv, last, table, lens)
                toks = logits.argmax(-1)
        t_capture = 0.0
        if replay:
            self.stats.decode_graph_replays += 1
        elif graphs is not None:
            # captured while the card runs the eager step
            t0 = time.monotonic()
            with obs.span("model_exec.capture", rows=b_b, width=maxp):
                graphs.capture(b_b, self.pool.kv)
            t_capture = time.monotonic() - t0
            self.stats.decode_graph_captures += 1
        with obs.span("model_exec.fetch", kind="decode"):
            nxt = toks.cpu().numpy()[:nb]
        self.stats.decode_launches += 1
        self.stats.host_syncs += 1
        with obs.span("engine.emit", kind="decode"):
            for e, tok in zip(decode_entries, nxt):
                self._emit(e.req, int(tok), emitted)
        return t_capture

    def _run_decode_spec(self, decode_entries: list, emitted: list) -> None:
        """Speculative decode: the draft proposes up to ``e.depth`` tokens
        per request, then ONE ``verify_step`` launch scores every
        (request, position) row packed together — depth-0 requests
        contribute their single plain-decode row.  Greedy acceptance takes
        the leading proposals that match the target argmax and emits one
        bonus token per match, so the stream equals plain decode (each
        verify row is a plain decode row; see kernels/spec_verify.py).
        Depth was capped at admission to the current block's remainder,
        so all speculative writes land in blocks the +1-token growth
        already reserved."""
        for e in decode_entries:
            self.pool.ensure_capacity(e.req.rid, e.l_kv + 1 + e.depth)
            if self.pool.ensure_writable(e.req.rid,
                                         e.l_kv // self.pool.block_size):
                self.bm.note_fork(e.req)
                self.stats.cow_forks += 1
        launches0 = self.draft.launches
        syncs0 = self.draft.syncs
        items = [(e.req.rid, self._seq_view(e.req), e.depth)
                 for e in decode_entries if e.depth > 0]
        proposals = self.draft.propose(items) if items else {}
        self.stats.draft_launches += self.draft.launches - launches0
        self.stats.host_syncs += self.draft.syncs - syncs0
        for e in decode_entries:
            if e.depth > 0 and e.req.rid not in proposals:
                e.depth = 0      # draft pool exhausted: plain decode row

        # pack one verify row per (request, draft position); tables stay
        # compact — one row per REQUEST — addressed via row_seg.  The
        # segment bucket reserves one extra all-zero row so padding rows'
        # K/V write lands in the null block (decode_step convention).
        rids = [e.req.rid for e in decode_entries]
        n_seg = len(decode_entries)
        rows: list[tuple] = []   # (entry index, token)
        for i, e in enumerate(decode_entries):
            rows.append((i, self._last_token(e.req)))
            for t in proposals.get(e.req.rid, [])[:e.depth]:
                rows.append((i, t))
        n_rows = len(rows)
        r_b = model_exec.seg_bucket(n_rows)
        s_b = model_exec.seg_bucket(n_seg + 1)
        maxp = max(len(self.pool.tables[r]) for r in rids)
        maxp_b = model_exec.table_bucket(maxp)
        tokens = np.zeros(r_b, np.int32)
        lens = np.zeros(r_b, np.int32)
        row_seg = np.full(r_b, n_seg, np.int32)   # padding -> zero table row
        starts = np.zeros(n_seg, np.int32)
        prev = -1
        for ri, (i, tok) in enumerate(rows):
            if i != prev:
                starts[i] = ri
                prev = i
            tokens[ri] = tok
            lens[ri] = decode_entries[i].l_kv + (ri - starts[i])
            row_seg[ri] = i
        tables = self.pool.table_array(rids, maxp=maxp_b, rows=s_b)
        self.stats.count_moe(model_exec.moe_work(self.cfg, r_b, 1, n_rows))
        # row_seg stays on the host: the verify kernel's wrapper checks it
        # there before each launch
        toks, self.pool.kv = model_exec.verify_step(
            self.cfg, self.params, self.pool.kv, self._dev(tokens), tables,
            self._dev(lens), torch.from_numpy(row_seg))
        self.stats.decode_launches += 1
        self.stats.host_syncs += 1
        out = toks.cpu().numpy()

        for i, e in enumerate(decode_entries):
            d = e.depth
            g = out[starts[i]:starts[i] + d + 1]
            props = proposals.get(e.req.rid, [])[:d]
            a = 0
            while a < d and props[a] == g[a]:
                a += 1
            for t in g[:a + 1]:
                self._emit(e.req, int(t), emitted)
            # bonus tokens advance context inside blocks the +1 growth
            # already covers (depth <= block remainder at admission)
            self.bm.state(e.req).dev_tokens += a
            if d > 0:
                self.draft.observe(e.req.rid, d, a)
                accept = getattr(self.policy, "spec_accept", None)
                if accept is not None:
                    accept.update(d, a)
            self.stats.spec_proposed += d
            self.stats.spec_accepted += a
            self.stats.spec_rejected += d - a
            self.stats.spec_depth_hist[d] = \
                self.stats.spec_depth_hist.get(d, 0) + 1

    # ------------------------------------------------------------------
    # prefill execution
    # ------------------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _seq_view(self, r: Request) -> np.ndarray:
        """Full known token sequence (prompt + outputs so far), maintained
        incrementally — no per-chunk concatenation."""
        return self._seqs[r.rid][:self._seq_fill[r.rid]]

    def _prepare_prefill(self, e) -> None:
        """Block-table growth + CoW guard shared by both prefill paths."""
        r, ctx = e.req, e.l_kv
        self.pool.ensure_capacity(r.rid, ctx + e.n_tokens)
        # CoW guard: the first block written this pass may be shared
        # (all later blocks are freshly allocated)
        if self.pool.ensure_writable(r.rid, ctx // self.pool.block_size):
            self.bm.note_fork(r)
            self.stats.cow_forks += 1

    def _finish_prefill(self, e, tok: int, emitted: list) -> None:
        """Prompt-completion bookkeeping: emit the first token and adopt
        the prompt's full blocks into the prefix cache."""
        r = e.req
        self._emit(r, tok, emitted)
        if self.cache is not None:
            # charge moves request -> cache; blocks now shared
            prompt: np.ndarray = r._prompt  # type: ignore
            adopted = self.cache.insert(
                prompt, self.pool.tables[r.rid], r.rid, self.now, r.weight)
            if adopted:
                self.bm.donate_to_cache(r, adopted)
                self.stats.cache_insert_blocks += adopted
            self.cache.shrink_to_capacity()

    def _run_prefill_packed(self, entries: list, emitted: list) -> None:
        """Packed multi-request prefill: every chunk this step concatenated
        into one flat token stream and executed in a single bucketed call —
        and each segment stages only the blocks it needs."""
        bs = self.pool.block_size
        n_seg = len(entries)
        total = sum(e.n_tokens for e in entries)
        with obs.span("model_exec.prep", kind="prefill"):
            for e in entries:
                self._prepare_prefill(e)
            sq = model_exec.chunk_bucket(max(e.n_tokens for e in entries))
            smax = model_exec.chunk_bucket(
                max(e.l_kv + e.n_tokens for e in entries))
            smax = -(-smax // bs) * bs
            maxp = smax // bs
            t_b = model_exec.flat_bucket(total)
            s_b = model_exec.seg_bucket(n_seg)

            tokens = np.zeros((1, t_b), np.int32)
            positions = np.zeros((1, t_b), np.int32)
            q_rows = np.full((t_b,), s_b, np.int32)  # padding -> extra row
            q_cols = np.zeros((t_b,), np.int32)
            sblocks = np.zeros((t_b,), np.int32)     # padding -> null block
            sslots = np.zeros((t_b,), np.int32)
            tables = np.zeros((s_b, maxp), np.int32)
            ctx_lens = np.zeros((s_b,), np.int32)
            last_idx = np.zeros((s_b,), np.int32)
            off = 0
            for i, e in enumerate(entries):
                r, ctx, n = e.req, e.l_kv, e.n_tokens
                seq = self._seq_view(r)
                tokens[0, off:off + n] = seq[ctx:ctx + n]
                pos = np.arange(ctx, ctx + n, dtype=np.int32)
                positions[0, off:off + n] = pos
                q_rows[off:off + n] = i
                q_cols[off:off + n] = np.arange(n, dtype=np.int32)
                t = np.asarray(self.pool.tables[r.rid], np.int32)
                sblocks[off:off + n] = t[pos // bs]
                sslots[off:off + n] = pos % bs
                k = min(len(t), maxp)
                tables[i, :k] = t[:k]
                ctx_lens[i] = ctx
                last_idx[i] = off + n - 1
                off += n

        with obs.span("model_exec.upload", kind="prefill"):
            inputs = [self._dev(a) for a in (
                tokens, positions, q_rows, q_cols, sblocks, sslots, tables,
                ctx_lens, last_idx)]
        work = model_exec.moe_work(self.cfg, 1, t_b, total)
        self.stats.count_moe(work)
        with obs.span("model_exec.launch", kind="prefill", rows=n_seg,
                      tokens=total, **work):
            logits, self.pool.kv = model_exec.prefill_packed(
                self.cfg, self.params, self.pool.kv, *inputs, smax, sq)
        self.stats.packed_prefill_calls += 1
        self.stats.host_syncs += 1
        with obs.span("model_exec.fetch", kind="prefill"):
            nxt = logits.argmax(-1).cpu().numpy()
        with obs.span("engine.emit", kind="prefill"):
            for i, e in enumerate(entries):
                r = e.req
                self.stats.prefill_tokens += e.n_tokens
                if e.l_kv + e.n_tokens >= r.prompt_len and r.generated == 0:
                    self._finish_prefill(e, int(nxt[i]), emitted)
                # recompute completion emits nothing (next decode pass does)

    def _run_prefill_fallback(self, entries: list, emitted: list) -> None:
        """Per-request chunked prefill: one ``prefill_chunk`` call per
        entry, its chunk padded to ``bucket(n)``, the request's blocks
        staged contiguously over ``staging_span``.  The host fetches the
        logits only when a prompt completes."""
        bs = self.pool.block_size
        for e in entries:
            r, ctx, n = e.req, e.l_kv, e.n_tokens
            c = model_exec.bucket(n)
            self._prepare_prefill(e)
            toks = np.zeros((1, c), np.int32)
            toks[0, :n] = self._seq_view(r)[ctx:ctx + n]
            span = model_exec.staging_span(ctx, c, self.max_ctx, bs)
            table = self.pool.table_array([r.rid], maxp=span // bs)
            self.stats.count_moe(model_exec.moe_work(self.cfg, 1, c, n))
            logits, self.pool.kv = model_exec.prefill_chunk(
                self.cfg, self.params, self.pool.kv, self._dev(toks), table,
                self._dev(np.array([ctx], np.int32)), span)
            self.stats.prefill_chunk_calls += 1
            self.stats.prefill_tokens += n
            if ctx + n >= r.prompt_len and r.generated == 0:
                self.stats.host_syncs += 1
                tok = int(logits[0, n - 1].argmax())
                self._finish_prefill(e, tok, emitted)
            # recompute completion emits nothing (next decode pass does)

    # ------------------------------------------------------------------
    def _last_token(self, r: Request) -> int:
        outs = self.outputs[r.rid]
        if outs:
            return outs[-1]
        return int(r._prompt[-1])  # type: ignore

    def _emit(self, r: Request, tok: int, emitted: list) -> None:
        self.outputs[r.rid].append(tok)
        seq, fill = self._seqs.get(r.rid), self._seq_fill.get(r.rid, 0)
        if seq is not None:
            if fill >= len(seq):    # defensive: output ran past output_len
                seq = np.concatenate([seq, np.zeros(len(seq), np.int32)])
                self._seqs[r.rid] = seq
            seq[fill] = tok
            self._seq_fill[r.rid] = fill + 1
        first = r.generated == 0
        r.emit_token(self.now)
        self.stats.tokens_out += 1
        emitted.append(r)
        last = r.phase == Phase.FINISHED
        at = self._t_req.get(r.rid)
        if at is not None and (last or at[0] == PREFILL):
            # the first token ends the prefill span, the last the decode
            t = time.monotonic()
            if at[0] == PREFILL:
                obs.record(PREFILL, at[1], t, rid=r.rid)
                at = (DECODE, t)
                self._t_req[r.rid] = at
            if last and at[0] == DECODE:
                obs.record(DECODE, at[1], t, rid=r.rid)
                del self._t_req[r.rid]
        if self.on_token is not None:
            self.on_token(r, tok, first, last)

    def _refit(self) -> None:
        try:
            batches = [b for b, _ in self._profile]
            lats = [l for _, l in self._profile]
            self.est = BatchLatencyEstimator.fit(batches, lats)
        except Exception:
            # keep serving on the previous fit, but never silently: count
            # every failure and log the first one per engine
            self.stats.refit_failures += 1
            if self.stats.refit_failures == 1:
                logger.warning(
                    "online estimator refit failed (keeping previous "
                    "coefficients); further failures are only counted",
                    exc_info=True)
        self._profile = self._profile[-200:]

    def flush_transfers(self, timeout: float = 30.0) -> bool:
        """Wait for the background lanes to drain, then fold the completed
        transfers into the accounting (tests / benchmarks)."""
        if self.worker is None:
            return True
        ok = self.worker.flush(timeout)
        self._drain_transfers()
        return ok

    def run_until_drained(self, max_iters: int = 10000) -> int:
        """Step until every request is done or a step forms no batch
        (nothing is schedulable), as the reference does; returns the steps
        that formed a batch."""
        it = 0
        while self.has_work() and it < max_iters:
            if self.step() is None:
                break
            it += 1
        return it

    def kill(self) -> list[Request]:
        """Stop the replica: stop the transfer worker and release every
        unfinished request, which is returned (its ``instance`` cleared),
        with the requests of handoff payloads not yet picked up."""
        self.alive = False
        if self.worker is not None:
            self.worker.stop()
        orphans = [r for r in self.queue if r.phase != Phase.FINISHED]
        for r in orphans:
            self.bm.release(r)
            self.pool.release(r.rid)
            if self.draft is not None:
                self.draft.drop(r.rid)
            self._t_req.pop(r.rid, None)
            r.instance = None
        self.queue.clear()
        # handoff payloads in flight or awaiting pickup die with the
        # replica — their requests must re-prefill elsewhere
        for payload, _, _ in self._handoff_wait.values():
            payload.req.instance = None
            orphans.append(payload.req)
        self._handoff_wait.clear()
        for payload in self._handoff_ready:
            payload.req.instance = None
            orphans.append(payload.req)
        self._handoff_ready.clear()
        return orphans


# --------------------------------------------------------------------------
# threaded driver loop
# --------------------------------------------------------------------------

class EngineDriver:
    """Runs one ``Engine``'s iteration loop on a dedicated thread.

    Submissions arrive on a per-instance inbox queue (fed by GoRouting
    dispatch in the ``ServiceFrontend``); each loop iteration drains the
    inbox into the engine queue, forms/executes one batch, and forwards
    token + step events to ``sink(event)``.  The sink is called on the
    driver thread and must be thread-safe (the frontend bridges into its
    asyncio loop with ``call_soon_threadsafe``).

    Unlike the reference, whose thread dies silently on an exception (a
    CUDA error, say), the driver keeps the exception in ``error``, sends
    a ``DriverFailed`` event to the sink and re-raises it as the cause of
    a ``DriverDied`` from ``join_idle`` and ``stop``.
    """

    def __init__(self, iid: int, engine: Engine,
                 sink: Callable[[object], None],
                 *, idle_wait: float = 2e-3, name: Optional[str] = None):
        self.iid = iid
        self.engine = engine
        self.sink = sink
        self.idle_wait = idle_wait
        self.inbox: "queue.Queue[tuple]" = queue.Queue()
        # rids added to THIS engine that have not yet emitted here —
        # drives StepEvent.prefill_done.  ``generated == 1`` would miss
        # failover-resumed requests whose first token predates this engine.
        self._awaiting_first: set[int] = set()
        self._first_done: list[int] = []
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=name or f"engine-driver-{iid}",
            daemon=True)
        engine.on_token = self._on_token

    # -- submission (any thread) ---------------------------------------
    def submit(self, req: Request, prompt_tokens,
               prior_outputs: Optional[list] = None) -> None:
        self.inbox.put(("req", req, prompt_tokens, prior_outputs,
                        time.monotonic() if obs.recorder().enabled
                        else None))
        self._idle.clear()

    def submit_handoff(self, payload: HandoffPayload) -> None:
        """Deliver a prefill peer's KV payload for adoption (decode leg)."""
        self.inbox.put(("handoff", payload))
        self._idle.clear()

    def pending(self) -> int:
        return self.inbox.qsize()

    @property
    def idle(self) -> bool:
        """True when the inbox is drained and the engine has no work."""
        return self._idle.is_set()

    def check(self) -> None:
        """Raise ``DriverDied`` if the driver thread raised."""
        if self.error is not None:
            raise DriverDied(f"engine driver {self.iid} died: "
                             f"{self.error!r}") from self.error

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread.start()

    def _join(self, timeout: float) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # never-started threads can't join
            self._thread.join(timeout)

    def stop(self, timeout: float = 10.0) -> None:
        self._join(timeout)
        self.check()

    def join_idle(self, timeout: float = 60.0) -> bool:
        """Block until the driver has drained all submitted work."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.check()
            if self._idle.is_set() and self.inbox.empty():
                return True
            time.sleep(1e-3)
        self.check()
        return False

    def kill(self) -> list[Request]:
        """Hard-stop the thread and return orphaned requests (plus any
        submissions still sitting in the inbox, never started).  A driver
        that died is killed the same way (its error stays in ``error``)."""
        self._join(timeout=120.0)    # a mid-step first launch can be slow
        orphans = self.engine.kill()
        while True:
            try:
                item = self.inbox.get_nowait()
            except queue.Empty:
                break
            orphans.append(item[1].req if item[0] == "handoff"
                           else item[1])
        return orphans

    # -- driver thread --------------------------------------------------
    def _on_token(self, req: Request, tok: int, first: bool,
                  last: bool) -> None:
        if req.rid in self._awaiting_first:
            self._awaiting_first.discard(req.rid)
            self._first_done.append(req.rid)
        self.sink(TokenEvent(req.rid, tok, req.generated,
                             time.monotonic(), first, last))

    def _run(self) -> None:
        try:
            self._loop()
        except Exception as exc:
            self.error = exc
            logger.error("engine driver %d died", self.iid, exc_info=True)
            self._idle.set()
            self.sink(DriverFailed(self.iid, exc))

    def _loop(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            drained = not self.inbox.empty()
            if drained:
                with obs.span("driver.inbox"):
                    self._drain_inbox()
            res = eng.step() if eng.alive else None
            handoffs = eng.take_handoffs()
            if handoffs:
                with obs.span("driver.events"):
                    for payload in handoffs:
                        payload.src_iid = self.iid
                        self.sink(HandoffEvent(self.iid, payload))
            if res is None:
                held = drained or eng.has_work()
                if not held:
                    self._idle.set()
                # park until new work or shutdown (also avoids a hot spin
                # when queued work is temporarily unschedulable); an idle
                # driver's parks are not recorded
                with (obs.span if held else obs.quiet)("driver.park"):
                    self._stop.wait(self.idle_wait)
                continue
            self._idle.clear()
            first_done, self._first_done = self._first_done, []
            with obs.span("driver.events"):
                self.sink(StepEvent(
                    iid=self.iid, free_blocks=eng.bm.free_blocks,
                    latency=res["latency"], est_time=res["plan"].est_time,
                    prefill_done=tuple(first_done),
                    finished=tuple(r.rid for r in res["finished"])))
            if not eng.has_work() and self.inbox.empty():
                self._idle.set()

    def _drain_inbox(self) -> None:
        """Move every submission waiting in the inbox into the engine."""
        eng = self.engine
        while True:
            try:
                item = self.inbox.get_nowait()
            except queue.Empty:
                return
            if item[0] == "handoff":
                payload = item[1]
                if eng.import_handoff(payload):
                    self.sink(HandoffAdopted(self.iid, payload))
                else:
                    self.sink(HandoffDropped(self.iid, payload))
            else:
                _, req, prompt, prior, t_submit = item
                if t_submit is not None:
                    obs.record("request.inbox", t_submit, time.monotonic(),
                               rid=req.rid)
                eng.add_request(req, prompt, prior_outputs=prior)
                self._awaiting_first.add(req.rid)
