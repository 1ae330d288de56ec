"""Replica sharding across processes: a GoRouting frontend exchanging
per-window dispatch/ack batches with replica shards over pipes.

The windowed loop (sim/windowed.py) removes the per-event global heap
but still routes every arrival against *instantaneous* frontend state,
which serializes routing and stepping in one process.  This module
trades that for throughput the same way the live service does: the
frontend's view of replica progress becomes **stale by up to one
window** (the live ``ServiceFrontend`` already routes on heartbeat-aged
``b_f`` and event logs that arrive after the fact — see
``core/gorouting.py`` ``InstanceState.apply_event``).  The loop:

1. the frontend routes every arrival in the next window ``[t, t+W)``
   against its current (boundary-frozen) ``InstanceState`` view,
   batching the dispatched requests per replica;
2. each shard advances its replicas through the window — arrivals and
   engine steps merged in time order per replica, exactly the windowed
   loop's chain semantics — and acks a column of replica-originated
   events ``(t, iid, kind, rid)`` plus fresh ``b_f``;
3. the frontend applies all shards' acks in deterministic
   ``(t, iid, arrival-order)`` order, refreshes ``b_f``, and opens the
   next window.

Because replicas never interact (coloc), a shard's trajectory depends
only on the dispatch batches it receives — which depend only on the
frontend's view — which is rebuilt from ack columns in an order
independent of how replicas were partitioned.  Hence **any partition of
replicas over workers (including the in-process ``workers=0`` twin)
yields identical per-request results and identical merged metrics**;
tests/test_shard_merge.py asserts this, and BENCH_replay_scale.json
carries a sharded-equivalence row.  Versus the exact (unwindowed)
simulation, window-delayed routing is a bounded *model* divergence —
quantified, not hidden: the bench's sharded rows report aggregate
metric deltas against the exact loop on the same trace.

Prefix-affinity routing reads remote cache state the frontend does not
have under sharding, so the frontend routes without affinity hints
(engine-side caches still hit at admission).  Disagg traces need
cross-shard handoffs and are not supported — use the reference loop.

Workers use the ``fork`` start method (the sim path imports no JAX, so
forking is safe and inherits the cluster factory without pickling);
platforms without ``fork`` get ``workers=0``.
"""
from __future__ import annotations

import heapq
import time
from typing import Iterable, Optional

from ..core.gorouting import EV_FINISHED, EV_PREFILL_DONE, QueuedStub
from ..core.request import Request
from .metrics import StreamingSummary
from .replay import ReplayReport

_INF = float("inf")

# per-engine counters summed into each shard's counter dict; integer,
# so cross-shard merge (plain addition) is exact under any partition
ENGINE_COUNTERS = ("iterations", "prefill_tokens", "copy_blocks",
                   "spec_proposed", "spec_accepted", "spec_rejected")


def merge_counters(into: dict, other: dict) -> dict:
    for k, v in other.items():
        into[k] = into.get(k, 0) + v
    return into


class ReplicaShard:
    """One worker's share of the cluster: a subset of replica engines
    advanced window by window.  Used identically in-process
    (``workers=0``) and inside forked workers, so both modes run the
    same code on identically constructed engines."""

    def __init__(self, cluster, iids: list[int], *, w_p: float, w_d: float,
                 bounded: bool = False, collect: bool = False):
        self.engines = {iid: cluster.engines[iid] for iid in iids}
        self.wake: dict[int, list[float]] = {iid: [] for iid in iids}
        self.summary = StreamingSummary(w_p=w_p, w_d=w_d, bounded=bounded)
        self.collect: Optional[list[Request]] = [] if collect else None

    def advance(self, t_end: float,
                batches: dict[int, list[Request]]) -> tuple:
        """Advance every owned replica through ``[prev t_end, t_end)``:
        the window's dispatched arrivals and the engine's pending wakes
        merged in time order (the windowed loop's chain semantics).
        Returns ``(events, b_f, pending)`` — the ack column."""
        events: list[tuple[float, int, int, int]] = []
        for iid, eng in self.engines.items():
            arr = batches.get(iid, ())
            h = self.wake[iid]
            ai = 0
            while True:
                t_a = arr[ai].arrival if ai < len(arr) else _INF
                t_s = h[0] if h else _INF
                if (t_a if t_a <= t_s else t_s) >= t_end:
                    break
                if t_a <= t_s:                         # arrival wins ties
                    req = arr[ai]
                    ai += 1
                    eng.add_request(req, t_a)
                    if eng.idle:
                        heapq.heappush(h, max(t_a, eng.busy_until))
                    continue
                t = heapq.heappop(h)
                if not eng.alive or t < eng.busy_until:
                    continue                           # stale duplicate wake
                res = eng.step(t)
                if res is None:
                    continue
                for r in res.prefill_done:
                    events.append((res.end, iid, EV_PREFILL_DONE, r.rid))
                for r in res.finished:
                    events.append((res.end, iid, EV_FINISHED, r.rid))
                    self.summary.add(r)
                    if self.collect is not None:
                        self.collect.append(r)
                    else:
                        r.out_times.clear()            # release timestamps
                heapq.heappush(h, res.end)
            # any arrival at t >= t_end would mean the frontend batched
            # it into the wrong window
            assert ai == len(arr), "arrival beyond window end"
        b_f = {iid: eng.bm.free_blocks for iid, eng in self.engines.items()}
        pending = any(self.wake[iid] for iid in self.engines)
        return events, b_f, pending

    def counters(self) -> dict:
        out = {k: 0 for k in ENGINE_COUNTERS}
        for eng in self.engines.values():
            for k in ENGINE_COUNTERS:
                out[k] += int(getattr(eng, k))
        return out


def _shard_worker(conn, cluster_factory, iids, w_p, w_d, bounded, collect):
    """Forked worker loop: build the cluster from the inherited factory
    (identical construction in every process), keep only the owned
    replicas, serve window messages until ``finish``."""
    try:
        cluster = cluster_factory()
        shard = ReplicaShard(cluster, iids, w_p=w_p, w_d=w_d,
                             bounded=bounded, collect=collect)
        while True:
            msg = conn.recv()
            if msg[0] == "window":
                conn.send(("ack",) + shard.advance(msg[1], msg[2]))
            elif msg[0] == "finish":
                conn.send(("done", shard.summary, shard.counters(),
                           shard.collect))
                return
    except Exception:                                  # pragma: no cover
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class ShardedWindowReplay:
    """Stale-view windowed replay: frontend here, replicas in shards.

    ``cluster_factory`` must build the SAME coloc cluster on every call
    (workers rebuild it post-fork); ``workers=0`` runs one in-process
    shard through the identical code path — the equivalence baseline
    the property tests compare multi-process runs against.
    """

    def __init__(self, cluster_factory, *, workers: int = 0,
                 window: Optional[float] = None,
                 w_p: float = 1.0, w_d: float = 1.0,
                 bounded: bool = False, collect: bool = False,
                 partition: Optional[list[list[int]]] = None):
        self.cluster = cluster_factory()
        if self.cluster.ccfg.pd_mode != "coloc":
            raise ValueError("sharded replay supports coloc clusters only")
        self.factory = cluster_factory
        self.states = self.cluster.states
        self.router = self.cluster.router
        self.est = self.cluster.est
        self.block_size = self.cluster.executor.block_size
        self.window = window or self.cluster.ccfg.heartbeat_interval
        self.w_p, self.w_d = w_p, w_d
        self.bounded, self.collect = bounded, collect
        self.workers = workers
        iids = sorted(self.cluster.engines)
        if partition is None:
            n = max(1, workers)
            partition = [iids[i::n] for i in range(n)]
            partition = [p for p in partition if p]
        self.partition = partition
        self.dropped: list[Request] = []
        self.n_windows = 0

    # ------------------------------------------------------------------
    def _route(self, req: Request, now: float) -> Optional[int]:
        """Stale-view routing: the reference ``ClusterSim._route`` minus
        affinity peeks and engine enqueue (those live replica-side)."""
        exec_est = self.est.prefill_time(req.prompt_len)
        p_iid, _ = self.router.select(
            req, list(self.states.values()), None, now,
            block_size=self.block_size, exec_est=exec_est, affinity=None)
        if p_iid is None:
            self.dropped.append(req)
            return None
        self.states[p_iid].on_dispatch(
            QueuedStub(req.rid, now, req.priority, req.weight,
                       req.prompt_len, req.arrival + req.slo.ttft,
                       exec_est), now)
        return p_iid

    def _apply_acks(self, acks: list[tuple]) -> bool:
        """Fold all shards' ack columns into the frontend view in
        partition-independent order: events sorted by (t, iid) with a
        stable sort (per-replica order is already chronological), then
        the boundary b_f refresh."""
        events: list[tuple[float, int, int, int]] = []
        pending = False
        for ev, b_f, pend in acks:
            events.extend(ev)
            pending = pending or pend
            for iid, b in b_f.items():
                self.states[iid].b_f = b
        events.sort(key=lambda e: (e[0], e[1]))
        for t, iid, kind, rid in events:
            self.states[iid].apply_event(kind, rid, t)
        return pending

    # ------------------------------------------------------------------
    def run_stream(self, request_iter: Iterable[Request]) -> tuple:
        """Replay sorted arrivals; returns ``(n_submitted, summary,
        counters, finished_or_None)`` with per-shard summaries/counters
        merged in shard order."""
        if self.workers > 0:
            return self._run(request_iter, _MPShards(self))
        shard = ReplicaShard(self.cluster, sorted(self.cluster.engines),
                             w_p=self.w_p, w_d=self.w_d,
                             bounded=self.bounded, collect=self.collect)
        return self._run(request_iter, _LocalShards([shard]))

    def _run(self, request_iter, shards) -> tuple:
        W = self.window
        it = iter(request_iter)
        nxt = next(it, None)
        t_end = W
        n_seen = 0
        pending = True
        try:
            while nxt is not None or pending:
                batches: dict[int, list[Request]] = {}
                while nxt is not None and nxt.arrival < t_end:
                    n_seen += 1
                    p_iid = self._route(nxt, nxt.arrival)
                    if p_iid is not None:
                        batches.setdefault(p_iid, []).append(nxt)
                    nxt = next(it, None)
                pending = self._apply_acks(shards.advance(t_end, batches))
                self.n_windows += 1
                t_end += W
            merged, counters, finished = shards.finish()
        finally:
            shards.close()
        return n_seen, merged, counters, finished


class _LocalShards:
    """In-process shard driver (workers=0)."""

    def __init__(self, shards: list[ReplicaShard]):
        self.shards = shards

    def advance(self, t_end, batches):
        return [s.advance(t_end, batches) for s in self.shards]

    def finish(self):
        merged, counters, finished = None, {}, []
        for s in self.shards:
            if merged is None:
                merged = s.summary
            else:
                merged.merge(s.summary)
            merge_counters(counters, s.counters())
            if s.collect is not None:
                finished.extend(s.collect)
        return merged, counters, (finished if finished else None)

    def close(self):
        pass


class _MPShards:
    """Forked-worker shard driver: one process + pipe per partition."""

    def __init__(self, rep: ShardedWindowReplay):
        import multiprocessing as mp
        try:
            ctx = mp.get_context("fork")
        except ValueError as e:                        # pragma: no cover
            raise RuntimeError(
                "sharded replay needs the 'fork' start method; "
                "use workers=0 on this platform") from e
        self.conns, self.procs = [], []
        self.owned = rep.partition
        for iids in rep.partition:
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_shard_worker,
                            args=(child, rep.factory, iids, rep.w_p,
                                  rep.w_d, rep.bounded, rep.collect),
                            daemon=True)
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)

    def _recv(self, conn):
        msg = conn.recv()
        if msg[0] == "error":
            raise RuntimeError(f"shard worker failed:\n{msg[1]}")
        return msg[1:]

    def advance(self, t_end, batches):
        # each worker only needs its own replicas' dispatch batches
        for conn, iids in zip(self.conns, self.owned):
            sub = {iid: batches[iid] for iid in iids if iid in batches}
            conn.send(("window", t_end, sub))
        return [self._recv(conn) for conn in self.conns]

    def finish(self):
        for conn in self.conns:
            conn.send(("finish",))
        merged, counters, finished = None, {}, []
        for conn in self.conns:
            summary, cnt, coll = self._recv(conn)
            if merged is None:
                merged = summary
            else:
                merged.merge(summary)
            merge_counters(counters, cnt)
            if coll is not None:
                finished.extend(coll)
        return merged, counters, (finished if finished else None)

    def close(self):
        for conn in self.conns:
            try:
                conn.close()
            except OSError:                            # pragma: no cover
                pass
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():                           # pragma: no cover
                p.terminate()


def replay_sim_sharded(cluster_factory, requests: Iterable[Request], *,
                       workers: int = 0, window: Optional[float] = None,
                       w_p: float = 1.0, w_d: float = 1.0,
                       bounded: bool = False, collect: bool = False,
                       partition: Optional[list[list[int]]] = None,
                       ) -> tuple[ReplayReport, dict]:
    """``replay_sim_stream`` over the sharded stale-view loop.

    Returns ``(report, extras)``; ``extras`` holds the merged engine
    counter dict, the window count, and (with ``collect=True``) the
    finished ``Request`` objects for per-request comparisons.  Dropped
    requests fold into the summary at the end, like the unsharded path.
    """
    rep = ShardedWindowReplay(cluster_factory, workers=workers,
                              window=window, w_p=w_p, w_d=w_d,
                              bounded=bounded, collect=collect,
                              partition=partition)
    t0 = time.monotonic()
    n_seen, merged, counters, finished = rep.run_stream(requests)
    wall = time.monotonic() - t0
    done = merged.n
    for r in rep.dropped:
        merged.add(r)
    report = ReplayReport(summary=merged.summary(), n_submitted=n_seen,
                          n_completed=done, n_rejected=len(rep.dropped),
                          wall=wall, speed=float("inf"))
    extras = {"counters": counters, "windows": rep.n_windows,
              "workers": rep.workers, "window_s": rep.window,
              "finished": finished}
    return report, extras
