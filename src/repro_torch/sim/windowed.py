"""Windowed cross-replica event loop: batch replica advancement between
cluster-level sync points.

``ClusterSim.run``/``run_stream`` interleave every replica's STEP events
through one global heap — at 10⁵–10⁶ requests the heap traffic and
per-event Python dispatch dominate wall time.  This loop exploits a
structural property of the coloc simulator: **between two cluster-level
sync points, replica step chains commute.**  A STEP on replica *i* reads
and writes only engine *i* (its queue, block manager, prefix cache) and
``states[i]`` — never another replica.  The only events that read global
state are

* **arrivals** — ``_route`` reads every ``InstanceState`` (and, with
  prefix affinity, every engine's cache) to pick a replica; and
* **heartbeats** — refresh every ``states[iid].b_f`` from its engine.

So the loop runs: pop the earliest *global* event; if it is an arrival,
route it exactly as the reference does; otherwise advance **each**
replica's private step chain as far as the next sync barrier
(``min(next arrival, next heartbeat threshold)``), one replica at a time
with no interleaving.  Every step executes at the same simulated time,
on the same engine state, observing the same frontend state as in the
reference interleaving — results are **bitwise identical**, which
tests/test_windowed_sim.py asserts per-request (token timestamps,
finish times, preemption counts) and BENCH_replay_scale.json records as
an equivalence row (docs/ARCHITECTURE.md "Windowed event loop").

Reference semantics replicated exactly:

* **arrival-wins-ties** — an arrival at the same timestamp as a step is
  processed first (``run`` pushes arrivals with the lowest seqs;
  ``run_stream`` takes ``nxt.arrival <= heap[0][0]``).  Here:
  ``t_arr <= t_step`` selects the arrival.
* **heartbeat timing** — the reference fires when a popped event
  satisfies ``now - last_hb >= interval`` and sets ``last_hb = now``
  (the *event's* time, not the threshold).  Here the global next-event
  time is exactly that ``now``, and chains are barriered *below*
  ``last_hb + interval`` so no step can run past an unfired heartbeat.
* **duplicate wake-ups** — dispatch pushes a STEP whenever the engine
  is idle, so an engine can hold several pending wakes; a wake at
  ``t < eng.busy_until`` is stale and skipped.  Per-engine min-heaps
  preserve exactly these semantics (a dict of next-wake times would
  drop the duplicates the reference later consumes).
* **until** — events with ``t > until`` are never executed (the
  reference breaks at the first such global event; since every earlier
  event has already run and later ones never affect requests already
  terminated, skipping them per-chain is equivalent).

Disaggregated mode shares HANDOFF events across tiers (prefill step →
decode arrival), whose tie-breaking depends on global heap sequence
numbers — chains there do NOT commute, so ``pd_mode="disagg"`` (and
kill/scale-up schedules) falls back to the inherited reference loop.

One observable difference, NOT part of the contract: ``on_finished``
callbacks within a window are delivered replica-by-replica rather than
globally time-interleaved.  Every derived metric is fold-order
independent (``StreamingSummary`` percentiles are multiset statistics;
its counters and integer-gain sums are associative), and each finished
``Request`` carries identical timestamps, so only a consumer that
depends on cross-replica callback interleaving could tell — none in
this repo does.
"""
from __future__ import annotations

import heapq
from typing import Optional

from ..core.request import Request
from .vector import VectorClusterSim

_INF = float("inf")


class WindowedClusterSim(VectorClusterSim):
    """``VectorClusterSim`` with the windowed outer loop (coloc traces);
    construction args are identical.  Falls back to the reference loop
    whenever the trace needs cross-replica events (disagg, kills,
    scale-ups), so it is always safe to use as a drop-in."""

    def run(self, requests: list[Request], *,
            until: Optional[float] = None,
            kills=None, scale_ups=None) -> list[Request]:
        if kills or scale_ups or self.ccfg.pd_mode != "coloc":
            return super().run(requests, until=until, kills=kills,
                               scale_ups=scale_ups)
        self._run_windowed(iter(sorted(requests, key=lambda r: r.arrival)),
                           until)
        return requests

    def run_stream(self, request_iter, *, until: Optional[float] = None,
                   on_finished=None) -> int:
        if self.ccfg.pd_mode != "coloc":
            return super().run_stream(request_iter, until=until,
                                      on_finished=on_finished)
        self.on_finished = on_finished
        try:
            return self._run_windowed(iter(request_iter), until)
        finally:
            self.on_finished = None

    # ------------------------------------------------------------------
    def _run_windowed(self, it, until: Optional[float]) -> int:
        hb_iv = self.ccfg.heartbeat_interval
        engines = self.engines
        # iid -> min-heap of pending wake times (see module docstring on
        # why duplicates must be kept, not collapsed)
        wake: dict[int, list[float]] = {}
        nxt = next(it, None)
        n_seen = 0
        last_hb = 0.0
        while True:
            t_arr = nxt.arrival if nxt is not None else _INF
            t_step = _INF
            for h in wake.values():
                if h and h[0] < t_step:
                    t_step = h[0]
            t_ev = t_arr if t_arr <= t_step else t_step
            if t_ev == _INF:
                break
            if until is not None and t_ev > until:
                break
            if t_ev - last_hb >= hb_iv:
                self._heartbeat(t_ev)
                last_hb = t_ev
            if t_arr <= t_step:
                n_seen += 1
                p_iid = self._route(nxt, t_arr)
                if p_iid is not None:
                    eng = engines[p_iid]
                    if eng.idle:
                        h = wake.get(p_iid)
                        if h is None:
                            h = wake[p_iid] = []
                        heapq.heappush(h, max(t_arr, eng.busy_until))
                nxt = next(it, None)
            else:
                # advance all replica chains to the next sync barrier
                barrier = last_hb + hb_iv
                if t_arr < barrier:
                    barrier = t_arr
                for iid, h in wake.items():
                    if h and h[0] < barrier:
                        self._advance_chain(iid, h, barrier, until)
        return n_seen

    def _advance_chain(self, iid: int, h: list[float], barrier: float,
                       until: Optional[float]) -> None:
        """Run replica ``iid``'s private step chain up to (not including)
        ``barrier``.  Commutes with every other replica's chain — see the
        module docstring."""
        eng = self.engines[iid]
        while h and h[0] < barrier:
            if until is not None and h[0] > until:
                return
            t = heapq.heappop(h)
            if not eng.alive or t < eng.busy_until:
                continue           # stale duplicate wake (reference no-op)
            res = eng.step(t)
            if res is None:
                continue
            self._on_step_result(iid, eng, res, None, None)
            heapq.heappush(h, res.end)
