"""Draft-model runner for greedy speculative decoding (port of
``repro.serving.spec``).

The ``DraftRunner`` keeps a small draft model (its own params and its own
``PagedKVPool``, on the engine's device and in its dtype, with no transfer
worker) in lockstep with the target engine's token streams.  For each
speculating request the engine hands over the full known sequence
(prompt + outputs) and a depth ``k``; the runner

  1. catches the draft KV up to the sequence (large gaps — the first
     engagement's prompt — ingest via ``prefill_chunk``, exactly like the
     engine's per-request prefill; small gaps ride the decode feed rounds
     below, so output tokens get their draft KV from the same decode math
     the target used),
  2. feeds the remaining known tokens and then its own proposals through
     batched ``decode_step`` rounds shared across all speculating
     requests, collecting ``k`` greedy proposals per request.

Draft KV slots are position-addressed, so a rejected proposal's stale KV
is simply overwritten when the (corrected) token at that position is fed
on a later engagement — ``observe`` records how far the draft context is
known-good after each verify.  All draft state for a request dies with
``drop`` (finish / evict / kill): re-engagement re-ingests from the
target's authoritative sequence.

Nothing here affects the emitted streams: the target's packed verify
recomputes every position and greedy acceptance keeps the output equal to
non-speculative decode; the draft only decides how many positions are
worth verifying.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.model import ArchConfig
from . import model_exec
from .kv_pool import PagedKVPool

# gaps larger than this are ingested with one prefill_chunk call instead
# of riding the per-token decode feed rounds (first engagement = prompt)
GAP_PREFILL = 8


class DraftRunner:
    def __init__(self, cfg: ArchConfig, params: dict, *,
                 num_blocks: int = 512, block_size: int = 16,
                 max_ctx: int = 1024, dtype=torch.float32, device="cuda"):
        model_exec.require_paged(cfg)
        self.cfg = cfg
        self.params = params
        self.pool = PagedKVPool(cfg, num_blocks, block_size, dtype=dtype,
                                device=device)
        self.device = self.pool.device
        self.max_ctx = max_ctx
        # rid -> leading draft-KV positions that match the target stream
        self.ctx: dict[int, int] = {}
        # rid -> target context at propose time (awaiting observe())
        self._pending: dict[int, int] = {}
        self.launches = 0      # draft model calls (prefill + decode rounds)
        self.syncs = 0         # device->host fetches (decode rounds only)

    # ------------------------------------------------------------------
    def drop(self, rid: int) -> None:
        """Forget a request's draft state and free its draft-pool blocks
        (finish / evict / engine kill)."""
        if rid in self.ctx or rid in self._pending:
            self.ctx.pop(rid, None)
            self._pending.pop(rid, None)
            self.pool.release(rid)

    def observe(self, rid: int, depth: int, accepted: int) -> None:
        """Verify outcome for the last propose(): positions up to the last
        accepted proposal hold correct KV (the proposal at ``accepted``
        was refuted and its successors were never written)."""
        tgt = self._pending.pop(rid, None)
        if tgt is not None:
            self.ctx[rid] = tgt + min(accepted + 1, depth)

    # ------------------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _ingest(self, rid: int, seq: np.ndarray, ctx: int, tgt: int) -> None:
        """Catch the draft KV up over [ctx, tgt) with one chunked prefill
        (same bucketing as the engine's per-request prefill path)."""
        n = tgt - ctx
        c = model_exec.bucket(n)
        toks = np.zeros((1, c), np.int32)
        toks[0, :n] = seq[ctx:tgt]
        span = model_exec.staging_span(ctx, c, self.max_ctx,
                                       self.pool.block_size)
        table = self.pool.table_array(
            [rid], maxp=span // self.pool.block_size)
        _, self.pool.kv = model_exec.prefill_chunk(
            self.cfg, self.params, self.pool.kv, self._dev(toks), table,
            self._dev(np.array([ctx], np.int32)), span)
        self.launches += 1
        self.ctx[rid] = tgt

    def propose(self, items: list[tuple[int, np.ndarray, int]]
                ) -> dict[int, list[int]]:
        """Greedy draft proposals for a batch of speculating requests.

        ``items``: (rid, full known token sequence, depth > 0).  Returns
        rid -> depth proposals; a rid missing from the result could not be
        engaged (draft pool exhausted) and should run at depth 0.
        """
        out: dict[int, list[int]] = {}
        live: list[dict] = []
        for rid, seq, depth in items:
            tgt = len(seq) - 1
            if not self.pool.ensure_capacity(rid, tgt + depth):
                self.drop(rid)
                continue
            ctx = self.ctx.get(rid, 0)
            if tgt - ctx > GAP_PREFILL:
                self._ingest(rid, seq, ctx, tgt)
                ctx = tgt
            # feed positions ctx..tgt+depth-1: known tokens first, then
            # each round's own proposal; outputs at positions >= tgt are
            # the proposals
            live.append({"rid": rid, "pos": ctx, "last": 0,
                         "feeds": [int(t) for t in seq[ctx:tgt + 1]],
                         "n_left": (tgt - ctx) + depth})
            self._pending[rid] = tgt
            self.ctx[rid] = tgt
            out[rid] = []
        while True:
            active = [s for s in live if s["n_left"] > 0]
            if not active:
                break
            nb = len(active)
            b_b = model_exec.seg_bucket(nb)
            maxp = max(len(self.pool.tables[s["rid"]]) for s in active)
            maxp_b = model_exec.table_bucket(maxp)
            lens = np.zeros(b_b, np.int32)
            last = np.zeros(b_b, np.int32)
            for i, s in enumerate(active):
                lens[i] = s["pos"]
                last[i] = s["feeds"].pop(0) if s["feeds"] else s["last"]
            table = self.pool.table_array([s["rid"] for s in active],
                                          maxp=maxp_b, rows=b_b)
            toks, self.pool.kv = model_exec.decode_step(
                self.cfg, self.params, self.pool.kv, self._dev(last), table,
                self._dev(lens))
            self.launches += 1
            self.syncs += 1
            nxt = toks.cpu().numpy()[:nb]
            for s, t in zip(active, nxt):
                s["pos"] += 1
                s["n_left"] -= 1
                s["last"] = int(t)
                if s["pos"] > self._pending[s["rid"]]:
                    out[s["rid"]].append(int(t))
        return out
