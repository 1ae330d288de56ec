"""Serving engine: continuous batching over a PyTorch model on the card
(port of ``repro.serving.engine``, colocated role).

One ``Engine`` = one model replica.  Each iteration:

  1. the policy (``SlideBatching``, the same scheduling core the simulator
     runs) forms a batch against the BlockManager accounting;
  2. eviction and reload directives are applied to the PagedKVPool: an
     evicted request's surviving span is copied to host in one gather and
     one device-to-host copy, and a reload is one batched host-to-device
     scatter;
  3. prefill chunks run PACKED — every request's chunk in one
     ``prefill_packed`` call — greedy-sampling the first token when a
     prompt completes; decode entries run as one fused ``decode_step``;
  4. measured wall-clock batch latencies feed the §4.1 estimator, which is
     refit online every ``refit_every`` batches.

Each model launch costs exactly one device-to-host fetch (the sampled
tokens), counted in ``EngineStats.host_syncs``.

Not ported yet (each raises ``NotImplementedError``): the background
transfer lanes (``overlap_transfers=True``), the bounded host tier and
int8 cold tier (``host_tier_bytes``), speculative decoding
(``spec_draft`` / ``spec_k > 0``), the prefill / decode roles and their
handoff (``role != "coloc"``, ``handoff_quantize``), and the per-request
prefill and logits-decode fallbacks (``packed_prefill=False``,
``fused_decode=False``).
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..core.batching import BatchPlan, EngineConfig, SchedView
from ..core.blocks import BlockManager, blocks_for
from ..core.estimator import BatchLatencyEstimator
from ..core.request import Phase, Request
from ..models.model import ArchConfig, require_dense, resolve_device
from . import model_exec
from .kv_pool import PagedKVPool
from .prefix_cache import RadixPrefixCache

logger = logging.getLogger(__name__)


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
    transfer_wait_s: float = 0.0   # total step time stalled on sync copies
    refit_failures: int = 0        # online estimator refits that failed
    decode_launches: int = 0       # decode_step calls (one per step with
    # decode work)
    host_bytes: int = 0            # current host-tier bytes
    host_syncs: int = 0            # device->host fetches in the hot loop —
    # exactly one per model launch (no hidden syncs)
    # bounded: long-lived replicas must not grow without limit
    batch_latencies: deque = field(
        default_factory=lambda: deque(maxlen=512))


def _unported(flag: str) -> NotImplementedError:
    return NotImplementedError(f"Engine({flag}) is not ported to "
                               "repro_torch yet")


class Engine:
    def __init__(self, cfg: ArchConfig, params: dict, eng_cfg: EngineConfig,
                 policy, *, num_blocks: int = 512, block_size: int = 16,
                 t_block: float = 5e-4,
                 est: Optional[BatchLatencyEstimator] = None,
                 bm_kwargs: Optional[dict] = None,
                 prefix_cache: bool = True,
                 cache_blocks: Optional[int] = None,
                 packed_prefill: bool = True,
                 overlap_transfers: bool = False,
                 fused_decode: bool = True,
                 host_tier_bytes: Optional[int] = None,
                 role: str = "coloc",
                 handoff_quantize: bool = False,
                 spec_draft: Optional[tuple] = None,
                 device="cuda"):
        """``params`` must already live on ``device`` (default the card;
        ``device="cpu"`` runs the plain PyTorch kernel versions).  The
        flags of the reference that are not ported yet are accepted only
        at their one supported value and raise otherwise."""
        if role not in ("coloc", "prefill", "decode"):
            raise ValueError(f"unknown engine role: {role!r}")
        for flag, unported in (
                ("role=" + repr(role), role != "coloc"),
                ("overlap_transfers=True", overlap_transfers),
                ("host_tier_bytes", host_tier_bytes is not None),
                ("spec_draft", spec_draft is not None),
                ("spec_k > 0", eng_cfg.spec_k > 0),
                ("packed_prefill=False", not packed_prefill),
                ("fused_decode=False", not fused_decode),
                ("handoff_quantize=True", handoff_quantize)):
            if unported:
                raise _unported(flag)
        require_dense(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.eng_cfg = eng_cfg
        self.policy = policy
        self.pool = PagedKVPool(cfg, num_blocks, block_size,
                                dtype=params["embed"].dtype,
                                device=self.device)
        self.bm = BlockManager(num_blocks - 1, block_size, t_block,
                               **(bm_kwargs or {}))
        # radix prefix cache: shares prompt KV across requests (refcounted
        # blocks, CoW); holds at most ``cache_blocks`` beyond live pins and
        # yields them back on demand (BlockManager.reclaim_cache)
        self.cache: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.pool, self.bm, max_blocks=cache_blocks)
            if prefix_cache else None)
        self.est = est or BatchLatencyEstimator(
            a_p=1e-8, b_p=1e-8, c_p=1e-5, a_d=1e-8, b_d=1e-4, t_c=1e-3)
        # full token sequence (prompt + outputs) per request, appended
        # incrementally — avoids the per-chunk prompt+outputs rebuild
        self._seqs: dict[int, np.ndarray] = {}
        self._seq_fill: dict[int, int] = {}
        self.queue: list[Request] = []
        self.now = 0.0
        # when set, ``now`` tracks wall time relative to a shared epoch
        self._wall_epoch: Optional[float] = None
        self.stats = EngineStats()
        self._profile: list[tuple[list, float]] = []
        self.refit_every = 50
        self.outputs: dict[int, list[int]] = {}
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
        return any(r.phase != Phase.FINISHED for r in self.queue)

    # ------------------------------------------------------------------
    def _evict_to_host(self, r: Request) -> None:
        """Apply one (already accounted) eviction to the data layer: copy
        the surviving span's missing blocks to host in one batched device
        fetch, then drop the device references."""
        s = self.bm.state(r)
        keep_blocks = blocks_for(s.host_tokens, self.bm.block_size)
        if keep_blocks:
            missing = [bi for bi in range(keep_blocks)
                       if not self.pool.tier.has_block(r.rid, bi)]
            self.pool.offload_blocks(r.rid, missing)
        self.pool.drop_device_blocks(r.rid)
        self.stats.evictions += 1

    def _sync_pool_with_bm(self, plan: BatchPlan) -> None:
        """Apply the §4.3 directives the policy issued on the accounting
        layer (BlockManager) to the actual data (PagedKVPool)."""
        for r in plan.evictions:
            self._evict_to_host(r)

    def use_wall_clock(self, epoch: float) -> None:
        """Drive ``now`` from ``time.monotonic() - epoch`` (shared across
        replicas) instead of the per-engine virtual latency accumulator."""
        self._wall_epoch = epoch
        self.now = max(self.now, time.monotonic() - epoch)

    def step(self) -> Optional[dict]:
        if self._wall_epoch is not None:
            self.now = max(self.now, time.monotonic() - self._wall_epoch)
        self.bm.complete_offloads(self.now)
        self.stats.host_bytes = self.pool.tier.host_bytes
        view = SchedView(self.queue, self.bm, self.est, self.eng_cfg,
                         self.now)
        plan = self.policy.form_batch(view)
        if not plan.entries:
            # evictions can outlive a failed admission round: keep the
            # pool consistent with the accounting before going idle
            if plan.evictions:
                self._sync_pool_with_bm(plan)
            return None
        t0 = time.monotonic()
        self._sync_pool_with_bm(plan)

        # reload data for requests whose plan restored host blocks: one
        # synchronous batched copy per request
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
                tr0 = time.monotonic()
                self.pool.reload_blocks(e.req.rid, n)
                step_wait += time.monotonic() - tr0
                self.stats.reload_blocks += n
                step_reload += n
        self.stats.transfer_wait_s += step_wait

        decode_entries = [e for e in plan.entries if not e.is_prefill]
        prefill_entries = [e for e in plan.entries if e.is_prefill]
        emitted: list[Request] = []
        if prefill_entries:
            self._run_prefill_packed(prefill_entries, emitted)
        if decode_entries:
            self._run_decode(decode_entries, emitted)

        latency = time.monotonic() - t0
        if self._wall_epoch is not None:
            self.now = max(self.now, time.monotonic() - self._wall_epoch)
        else:
            self.now += latency
        self.stats.iterations += 1
        self.stats.batch_latencies.append(latency)
        self._profile.append((plan.work_items(), latency))
        if len(self._profile) >= self.refit_every:
            self._refit()

        finished = [r for r in self.queue if r.phase == Phase.FINISHED]
        for r in finished:
            self.bm.release(r)
            self.pool.release(r.rid)
            self._seqs.pop(r.rid, None)
            self._seq_fill.pop(r.rid, None)
        self.queue = [r for r in self.queue if r.phase != Phase.FINISHED]
        return {"emitted": emitted, "finished": finished,
                "latency": latency, "plan": plan,
                "reload_blocks": step_reload,
                "transfer_wait": step_wait}

    # ------------------------------------------------------------------
    # decode execution
    # ------------------------------------------------------------------
    def _run_decode(self, decode_entries: list, emitted: list) -> None:
        """Fused decode: one token per request in one launch.  The batch
        and table are padded to shape buckets (extra rows: token 0, len 0,
        null-block table) and only the (B,) argmax comes back."""
        rids = [e.req.rid for e in decode_entries]
        nb = len(decode_entries)
        for e in decode_entries:
            self.pool.ensure_capacity(e.req.rid, e.l_kv + 1)
            if self.pool.ensure_writable(e.req.rid,
                                         e.l_kv // self.pool.block_size):
                self.bm.note_fork(e.req)
                self.stats.cow_forks += 1
        maxp = max(len(self.pool.tables[r]) for r in rids)
        b_b = model_exec.seg_bucket(nb)
        maxp_b = model_exec.table_bucket(maxp)
        lens = np.zeros(b_b, np.int32)
        lens[:nb] = [e.l_kv for e in decode_entries]
        last = np.zeros(b_b, np.int32)
        last[:nb] = [self._last_token(e.req) for e in decode_entries]
        table = self.pool.table_array(rids, maxp=maxp_b, rows=b_b)
        toks, self.pool.kv = model_exec.decode_step(
            self.cfg, self.params, self.pool.kv, self._dev(last), table,
            self._dev(lens))
        nxt = toks.cpu().numpy()[:nb]
        self.stats.decode_launches += 1
        self.stats.host_syncs += 1
        for e, tok in zip(decode_entries, nxt):
            self._emit(e.req, int(tok), emitted)

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
        """Block-table growth + CoW guard before a prefill chunk."""
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
        for e in entries:
            self._prepare_prefill(e)
        n_seg = len(entries)
        sq = model_exec.chunk_bucket(max(e.n_tokens for e in entries))
        smax = model_exec.chunk_bucket(
            max(e.l_kv + e.n_tokens for e in entries))
        smax = -(-smax // bs) * bs
        maxp = smax // bs
        total = sum(e.n_tokens for e in entries)
        t_b = model_exec.flat_bucket(total)
        s_b = model_exec.seg_bucket(n_seg)

        tokens = np.zeros((1, t_b), np.int32)
        positions = np.zeros((1, t_b), np.int32)
        q_rows = np.full((t_b,), s_b, np.int32)   # padding -> extra row
        q_cols = np.zeros((t_b,), np.int32)
        sblocks = np.zeros((t_b,), np.int32)      # padding -> null block 0
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

        d = self._dev
        logits, self.pool.kv = model_exec.prefill_packed(
            self.cfg, self.params, self.pool.kv, d(tokens), d(positions),
            d(q_rows), d(q_cols), d(sblocks), d(sslots), d(tables),
            d(ctx_lens), d(last_idx), smax, sq)
        self.stats.packed_prefill_calls += 1
        self.stats.host_syncs += 1
        nxt = logits.argmax(-1).cpu().numpy()
        for i, e in enumerate(entries):
            r = e.req
            self.stats.prefill_tokens += e.n_tokens
            if e.l_kv + e.n_tokens >= r.prompt_len and r.generated == 0:
                self._finish_prefill(e, int(nxt[i]), emitted)
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
        if self.on_token is not None:
            self.on_token(r, tok, first, r.phase == Phase.FINISHED)

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

    def run_until_drained(self, max_iters: int = 10000) -> None:
        it = 0
        while self.has_work() and it < max_iters:
            if self.step() is None:
                # idle but queued work exists only if nothing schedulable
                break
            it += 1
