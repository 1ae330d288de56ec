"""Wall-clock sanity check for the engine hot loop of the PyTorch port
(counterpart of ``tools/perf_smoke.py``, which imports JAX).

Runs the same request sets through smoke-scale torch engines in
contrasting configurations and asserts that

  * baseline (per-request prefill, sync transfers) vs overlapped (packed
    prefill + async lanes) produce byte-identical token streams;
  * logits-fetch decode vs fused decode (argmax on device, shapes padded
    to buckets) produce byte-identical token streams;
  * the hot loop performs exactly ONE device->host fetch per model
    launch: ``stats.host_syncs == decode_launches + packed_prefill_calls``
    (any hidden sync added to the step path fails the gate);
  * a byte-bounded exact host tier keeps the unbounded mirror's streams
    and its budget, with tier traffic;
  * a live disagg fleet (1 prefill + 1 decode replica) streams what a
    coloc engine streams, and a matched ``ClusterSim`` replay reproduces
    the router book's disagg counters verbatim (sim<->live parity);
  * spec-on with a same-params draft streams what spec-off streams in
    fewer target launches, and a matched ``EngineSim`` replay reproduces
    the live speculation counters verbatim (sim<->live parity).

Each configuration gets one warm-up pass (kernel build, first launches),
then ``REPEATS`` timed passes, each in an adjacent pair with a pass of
the configuration it is compared with (the order alternating from pair
to pair), so that both passes of a pair meet the same host load; its
pass of median wall is reported.
The speed ratios are gated as in the reference, each on the median of
its per-pair ratios: the packed + overlapped prefill must reach
``--min-speedup`` (1.1x) of the per-request baseline's throughput, the
overlapped decode TPOT may not exceed the baseline's by more than
``--max-tpot-ratio`` (1.3x), and the fused decode TPOT may not exceed
the logits path's by more than ``--max-fused-ratio`` (1.2x).
The JSON payload is written to ``--out``
(default ``build/torch_perf_smoke.json``, git-ignored); no
``BENCH_*.json`` is written.

    PYTHONPATH=src python tools/torch_perf_smoke.py             # the card
    PYTHONPATH=src python tools/torch_perf_smoke.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_smoke                     # noqa: E402
from repro_torch.core import (EngineConfig, Request, SLO,      # noqa: E402
                              make_policy)
from repro_torch.models.model import (init_params,             # noqa: E402
                                      resolve_device)
from repro_torch.serving import Engine                        # noqa: E402

SCHEMA = 1
# timed runs per configuration after its warm-up: one run of a smoke-size
# engine lasts ~70 ms on the card, and one such run put the fused/logits
# ratio anywhere in 0.98-1.24x there
REPEATS = 5


def build_engine(cfg, params, *, packed: bool, overlap: bool,
                 fused: bool = True, max_ctx: int = 1024) -> Engine:
    dev = params["embed"].device
    # max_ctx matches the Engine default: the per-request fallback stages
    # the full max_ctx span per chunk, which is precisely the quadratic
    # term the packed path eliminates
    return Engine(cfg, params, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                  make_policy("slidebatching"), num_blocks=512,
                  block_size=16, max_ctx=max_ctx,
                  packed_prefill=packed, overlap_transfers=overlap,
                  fused_decode=fused, device=dev)


def make_trace(cfg, n_req: int, prompt_len: int, out_len: int, seed: int,
               vary_out: bool = False, priority: int = 2):
    """``vary_out`` draws per-request output lengths in
    [out_len/2, out_len], so the decode batch SHRINKS over the run —
    the shape churn that makes bucketed jit caching matter."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_req):
        ol = (int(rng.integers(max(1, out_len // 2), out_len + 1))
              if vary_out else out_len)
        reqs.append((Request(prompt_len=prompt_len, output_len=ol,
                             arrival=0.0, slo=SLO(3600.0, 3600.0),
                             priority=priority),
                     rng.integers(1, cfg.vocab, prompt_len).astype(np.int32)))
    return reqs


def run_once(cfg, params, trace, *, packed: bool, overlap: bool,
             fused: bool = True) -> tuple[dict, dict]:
    eng = build_engine(cfg, params, packed=packed, overlap=overlap,
                       fused=fused)
    for req, prompt in trace:
        eng.add_request(req, prompt)
    t0 = time.monotonic()
    eng.run_until_drained(max_iters=5000)
    wall = time.monotonic() - t0
    outputs = {i: eng.outputs[req.rid] for i, (req, _) in enumerate(trace)}
    decode_tokens = eng.stats.tokens_out - len(trace)  # first tokens excluded
    row = {
        "packed": packed, "overlap": overlap, "fused": fused,
        "wall_s": round(wall, 3),
        "prefill_tokens": eng.stats.prefill_tokens,
        "prefill_tok_per_s": round(eng.stats.prefill_tokens / wall, 1),
        "decode_tokens": decode_tokens,
        "tpot_proxy_ms": round(1e3 * wall / max(decode_tokens, 1), 3),
        "iterations": eng.stats.iterations,
        "packed_calls": eng.stats.packed_prefill_calls,
        "decode_launches": eng.stats.decode_launches,
        "host_syncs": eng.stats.host_syncs,
        # no-hidden-syncs accounting: exactly one fetch per model launch
        # (the fallback prefill path does one extra fetch per finishing
        # chunk, so the invariant is only asserted for packed engines)
        "hot_loop_fetches_ok": (
            not packed or eng.stats.host_syncs ==
            eng.stats.decode_launches + eng.stats.packed_prefill_calls),
    }
    eng.kill()
    return row, outputs


def time_configs(cfg, params, make, configs):
    """Run each of two engine configurations (``run_once`` flags) once to
    warm up, then ``REPEATS`` times in adjacent pairs, the pair's order
    alternating, so that host drift reaches both alike.  Returns each
    configuration's run of median wall, every pair's two rows, and
    whether every timed run streamed the same tokens."""
    for kw in configs:
        run_once(cfg, params, make(), **kw)
    runs = [[] for _ in configs]
    for r in range(REPEATS):
        order = (0, 1) if r % 2 == 0 else (1, 0)
        for j in order:
            runs[j].append(run_once(cfg, params, make(), **configs[j]))
    first = runs[0][0][1]
    same = all(outs == first for mine in runs for _, outs in mine)
    rows = [sorted(mine, key=lambda run: run[0]["wall_s"])[REPEATS // 2][0]
            for mine in runs]
    pairs = [(a[0], b[0]) for a, b in zip(*runs)]
    return rows, pairs, same


def pair_ratios(pairs, key: str) -> list[float]:
    """Each timed pair's second run's ``key`` over its first's: each ratio
    compares two passes under one host load.  The gates read the median."""
    return [b[key] / max(a[key], 1e-9) for a, b in pairs]


def measure_overlap(cfg, params, args, out_len):
    """Baseline vs overlapped engine on the same trace (both fused)."""
    return time_configs(
        cfg, params,
        lambda: make_trace(cfg, args.requests, args.prompt_len, out_len,
                           args.seed),
        (dict(packed=False, overlap=False), dict(packed=True, overlap=True)))


def measure_fused(cfg, params, args):
    """Logits-fetch vs fused decode on a decode-heavy trace with varied
    output lengths (batch shrinks over the run, exercising the bucketed
    jit cache instead of one compile per exact batch shape)."""
    return time_configs(
        cfg, params,
        lambda: make_trace(cfg, args.requests, args.prompt_len // 2,
                           args.decode_len * 2, args.seed, vary_out=True),
        (dict(packed=True, overlap=True, fused=False),
         dict(packed=True, overlap=True, fused=True)))


def measure_tier(cfg, params, args):
    """Tiered-KV invariants in exact mode (fp32 cold tier, no quantize):
    a preemption-heavy trace replayed with the legacy unbounded host
    mirror and with a 2-block byte-bounded host tier must emit identical
    token streams, and the bounded run must (a) keep the host tier within
    its byte budget with ``EngineStats.host_bytes`` agreeing with the
    pool's own accounting, and (b) actually push mirror/spill traffic
    through the tier (spills + LRU demotions to the cold dict)."""
    rows = {}
    streams = {}
    budget = None
    for label, bounded in (("unbounded", False), ("bounded", True)):
        eng = Engine(cfg, params, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                     make_policy("slidebatching"), num_blocks=10,
                     block_size=16, max_ctx=256,
                     host_tier_bytes=budget if bounded else None,
                     cold_quantize=False, device=params["embed"].device)
        if budget is None:
            budget = 2 * eng.pool.tier.block_bytes
            if bounded:          # first engine must already be bounded
                raise AssertionError("probe ordering bug")
        trace = make_trace(cfg, 4, 40, 6, args.seed)
        for req, prompt in trace:
            eng.add_request(req, prompt)
        eng.run_until_drained(max_iters=400)
        s, t = eng.stats, eng.pool.tier
        rows[label] = {
            "host_tier_bytes": budget if bounded else None,
            "evictions": s.evictions,
            "spill_blocks": s.spill_blocks,
            "cold_blocks": s.cold_blocks,
            "host_bytes": s.host_bytes,
            "tier_host_bytes": t.host_bytes,
            "demoted_blocks": t.demoted_blocks,
            "cold_reload_blocks": t.cold_reload_blocks,
        }
        streams[label] = {i: eng.outputs[req.rid]
                          for i, (req, _) in enumerate(trace)}
        eng.kill()
    b = rows["bounded"]
    failures = []
    if streams["unbounded"] != streams["bounded"]:
        failures.append("token streams diverged between unbounded host "
                        "mirror and byte-bounded tier (exact mode)")
    if b["host_bytes"] != b["tier_host_bytes"]:
        failures.append("EngineStats.host_bytes %d != tier accounting %d"
                        % (b["host_bytes"], b["tier_host_bytes"]))
    if b["host_bytes"] > budget:
        failures.append("host tier %d bytes exceeds its %d-byte budget"
                        % (b["host_bytes"], budget))
    if not (b["spill_blocks"] > 0 and b["demoted_blocks"] > 0):
        failures.append("bounded run saw no tier traffic (spills=%d, "
                        "demotions=%d) — not a preemption regime"
                        % (b["spill_blocks"], b["demoted_blocks"]))
    rows["streams_identical"] = streams["unbounded"] == streams["bounded"]
    return rows, failures


def measure_disagg(cfg, params, args):
    """Disaggregated serving parity: live disagg (1 prefill + 1 decode
    replica, KV handed off over the transfer lanes) vs a coloc engine on
    the same trace must emit bitwise-identical token streams with every
    admission-time reservation settling exactly (all hits, reserved ==
    adopted blocks); a matched ClusterSim replay must then reproduce the
    RouterBook's disagg counters verbatim (``sim.metrics.disagg_counters``
    dict equality — the sim<->live accounting contract)."""
    from repro_torch.core import GoRouting, RouterConfig, SLO, Request
    from repro_torch.core.estimator import BatchLatencyEstimator
    from repro_torch.serving import ServiceController
    from repro_torch.sim import (AnalyticalExecutor, ClusterConfig,
                                 ClusterSim, InstanceHardware, QWEN2_7B,
                                 disagg_counters, replay_sim)

    n = max(4, args.requests // 3)
    plen, olen = max(16, args.prompt_len // 4), 4
    trace = make_trace(cfg, n, plen, olen, args.seed)

    # coloc reference: one engine, direct drive
    ref = build_engine(cfg, params, packed=True, overlap=True, max_ctx=256)
    for req, prompt in trace:
        ref.add_request(Request(prompt_len=req.prompt_len,
                                output_len=req.output_len, arrival=0.0,
                                slo=SLO(3600.0, 3600.0),
                                priority=req.priority), prompt)
    ref.run_until_drained(max_iters=2000)
    ref_streams = [v for _, v in sorted(ref.outputs.items())]
    ref.kill()

    # live disagg: prefill + decode replicas behind the controller
    est = BatchLatencyEstimator(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8,
                                b_d=1e-3, t_c=1e-2)
    svc = ServiceController(GoRouting(est, RouterConfig(pd_mode="disagg")),
                            est)
    dev = params["embed"].device
    pe = Engine(cfg, params, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                make_policy("slidebatching"), num_blocks=512,
                block_size=16, max_ctx=256, role="prefill", device=dev)
    de = Engine(cfg, params, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                make_policy("slidebatching"), num_blocks=512,
                block_size=16, max_ctx=256, role="decode", device=dev)
    svc.add_instance(pe)
    svc.add_instance(de)
    for req, prompt in trace:
        svc.submit(req, prompt)
    svc.serve_until_drained()
    live_streams = [de.outputs.get(req.rid) for req, _ in trace]
    live = disagg_counters(svc.book)
    block_bytes = pe.pool.tier.block_bytes

    # matched sim replay: same request shapes through ClusterSim's disagg
    # path, wire bytes priced at the live pool's per-block footprint
    ex = AnalyticalExecutor(QWEN2_7B, InstanceHardware(chips=4))
    sim_est, _ = ex.fit_estimator(n=300)
    cs = ClusterSim(lambda: make_policy("slidebatching"),
                    GoRouting(sim_est, RouterConfig(pd_mode="disagg")),
                    ex, sim_est, EngineConfig(w_p=4.0),
                    ClusterConfig(pd_mode="disagg", n_prefill=1,
                                  n_decode=1, prefix_cache=False,
                                  handoff_block_bytes=block_bytes))
    sim_reqs = [Request(prompt_len=req.prompt_len,
                        output_len=req.output_len, arrival=0.0,
                        slo=SLO(3600.0, 3600.0), priority=req.priority)
                for req, _ in trace]
    replay_sim(cs, sim_reqs, w_p=4.0)
    sim = disagg_counters(cs)

    # stream comparison is positional: requests enter both fleets in the
    # same submission order, and rids ascend with it on each side
    row = {"n_requests": n, "prompt_len": plen, "out_len": olen,
           "block_bytes": block_bytes, "live": live, "sim": sim,
           "streams_identical": (
               [tuple(s) for s in live_streams if s is not None]
               == [tuple(s) for s in ref_streams]
               and all(s is not None for s in live_streams)),
           "parity": live == sim}
    failures = []
    if not row["streams_identical"]:
        failures.append("disagg token streams diverged from coloc")
    if not row["parity"]:
        failures.append(f"disagg sim<->live counter parity broke: "
                        f"live={live} sim={sim}")
    if live["reserved_blocks_total"] != live["adopted_blocks_total"]:
        failures.append("disagg reserved blocks %d != adopted blocks %d"
                        % (live["reserved_blocks_total"],
                           live["adopted_blocks_total"]))
    if live["reservation_hits"] != n or live["reservation_misses"]:
        failures.append("disagg reservations did not all settle as hits "
                        "(%d hits / %d misses over %d requests)"
                        % (live["reservation_hits"],
                           live["reservation_misses"], n))
    for eng in (pe, de):
        eng.kill()
    return row, failures


def measure_spec(cfg, params, args):
    """Speculative decoding (draft propose + packed verify, high-priority
    decode trace): spec-on with a same-params draft — every proposal
    matches the target argmax, the maximum-speculation regime — must emit
    token streams BITWISE identical to spec-off while finishing in fewer
    target launches (each accepted draft token rides a verify launch
    instead of buying its own decode launch); acceptance accounting must
    conserve with everything accepted; and an ``EngineSim`` replay with
    the acceptance draw pinned to always-accept must reproduce the live
    speculation counters verbatim (``sim.metrics.spec_counters`` dict
    equality — the sim<->live accounting contract).  Depth decisions are
    timing-free at this scale (load ~ 1e-12 of the tau budget; the
    acceptance EWMA only rises from its 0.8 prior, never crossing a
    pricing threshold for k=2), so sharing the estimator and pinning the
    online refit off makes the counter trajectory deterministic."""
    from repro_torch.core.estimator import BatchLatencyEstimator
    from repro_torch.sim import (AnalyticalExecutor, EngineSim,
                                 InstanceHardware, QWEN2_7B, spec_counters)

    n = max(4, args.requests // 3)
    plen, olen = max(16, args.prompt_len // 2), args.decode_len * 2
    est = BatchLatencyEstimator(a_p=1e-8, b_p=1e-8, c_p=1e-4, a_d=1e-8,
                                b_d=1e-3, t_c=1e-2)

    rows, streams, live = {}, {}, None
    for label, spec_k in (("off", 0), ("on", 2)):
        for _warm in (True, False):
            trace = make_trace(cfg, n, plen, olen, args.seed,
                               vary_out=True, priority=1)
            kw = {"spec_draft": (cfg, params)} if spec_k else {}
            eng = Engine(cfg, params,
                         EngineConfig(eta=1.0, w_p=4.0, tau=1e9,
                                      spec_k=spec_k),
                         make_policy("slidebatching"), num_blocks=512,
                         block_size=16, max_ctx=512, est=est,
                         device=params["embed"].device, **kw)
            eng.refit_every = 10 ** 9   # freeze pricing for sim parity
            for req, prompt in trace:
                eng.add_request(req, prompt)
            t0 = time.monotonic()
            eng.run_until_drained(max_iters=5000)
            wall = time.monotonic() - t0
            outs = {i: eng.outputs[req.rid]
                    for i, (req, _) in enumerate(trace)}
            st = eng.stats
            eng.kill()
        decode_tokens = st.tokens_out - n
        rows[label] = {
            "wall_s": round(wall, 3),
            "decode_tokens": decode_tokens,
            "decode_tok_per_s": round(decode_tokens / wall, 1),
            "decode_launches": st.decode_launches,
            "draft_launches": st.draft_launches,
        }
        streams[label] = outs
        if spec_k:
            live = spec_counters(st)
            rows[label].update(live)

    # matched EngineSim replay: same request shapes, same estimator, the
    # acceptance oracle pinned to the equal-params regime
    ex = AnalyticalExecutor(QWEN2_7B, InstanceHardware(chips=4))
    sim = EngineSim(0, make_policy("slidebatching"), ex, est,
                    EngineConfig(eta=1.0, w_p=4.0, tau=1e9, spec_k=2))
    sim.spec_accept_fn = lambda rid, step, depth, rate: depth
    now, guard = 0.0, 0
    for req, _ in make_trace(cfg, n, plen, olen, args.seed,
                             vary_out=True, priority=1):
        sim.add_request(req, now)
    while sim.has_work() and guard < 10000:
        guard += 1
        res = sim.step(now)
        if res is None:
            break
        now = res.end
    sim_c = spec_counters(sim)

    row = {"n_requests": n, "prompt_len": plen, "out_len": olen,
           "off": rows["off"], "on": rows["on"], "sim": sim_c,
           "streams_identical": streams["off"] == streams["on"],
           "launch_reduction": round(
               rows["off"]["decode_launches"]
               / max(rows["on"]["decode_launches"], 1), 2),
           "parity": live == sim_c}
    failures = []
    if not row["streams_identical"]:
        failures.append("token streams diverged between spec-off and "
                        "spec-on engines")
    if live["spec_proposed"] <= 0:
        failures.append("speculation never engaged (0 proposals)")
    if live["spec_accepted"] != live["spec_proposed"]:
        failures.append("same-params draft must be fully accepted "
                        "(%d/%d)" % (live["spec_accepted"],
                                     live["spec_proposed"]))
    if rows["on"]["decode_launches"] >= rows["off"]["decode_launches"]:
        failures.append("spec-on did not reduce target decode launches "
                        "(%d vs %d)" % (rows["on"]["decode_launches"],
                                        rows["off"]["decode_launches"]))
    if not row["parity"]:
        failures.append(f"spec sim<->live counter parity broke: "
                        f"live={live} sim={sim_c}")
    return row, failures


def collect(args) -> tuple[dict, list[str]]:
    """Run every measurement; return (payload, failure messages)."""
    dev = resolve_device(args.device)
    cfg = get_smoke("qwen1_5_0_5b")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)

    # prefill-heavy trace: one output token, so wall time IS prefill time
    (base_p, fast_p), pairs_p, same_p = measure_overlap(cfg, params, args,
                                                        1)
    # decode trace: several output tokens; the overlap engine leaves the
    # decode path alone, so its TPOT must not regress
    (base_d, fast_d), pairs_d, same_d = measure_overlap(cfg, params, args,
                                                        args.decode_len)
    (logits_row, fused_row), pairs_f, same_f = measure_fused(cfg, params,
                                                             args)
    tier_rows, tier_failures = measure_tier(cfg, params, args)
    disagg_row, disagg_failures = measure_disagg(cfg, params, args)
    spec_row, spec_failures = measure_spec(cfg, params, args)

    ratios_p = pair_ratios(pairs_p, "prefill_tok_per_s")
    ratios_d = pair_ratios(pairs_d, "tpot_proxy_ms")
    ratios_f = pair_ratios(pairs_f, "tpot_proxy_ms")
    speedup, tpot_ratio, fused_ratio = (
        float(np.median(r)) for r in (ratios_p, ratios_d, ratios_f))

    failures = (list(tier_failures) + list(disagg_failures)
                + list(spec_failures))
    if not (same_p and same_d):
        failures.append("token streams diverged between baseline and "
                        "overlapped engines")
    if not same_f:
        failures.append("token streams diverged between logits and fused "
                        "decode")
    if speedup < args.min_speedup:
        failures.append(f"prefill speedup {speedup:.2f}x < "
                        f"{args.min_speedup}x gate")
    if tpot_ratio > args.max_tpot_ratio:
        failures.append(f"decode TPOT ratio {tpot_ratio:.2f}x > "
                        f"{args.max_tpot_ratio}x gate")
    if fused_ratio > args.max_fused_ratio:
        failures.append(f"fused decode TPOT ratio {fused_ratio:.2f}x > "
                        f"{args.max_fused_ratio}x gate")
    for row in (fast_p, fast_d, logits_row, fused_row):
        if not row["hot_loop_fetches_ok"]:
            failures.append(
                "hidden host sync: host_syncs=%d != decode_launches=%d + "
                "packed_calls=%d" % (row["host_syncs"],
                                     row["decode_launches"],
                                     row["packed_calls"]))

    payload = {
        "schema": SCHEMA,
        "model": "qwen1_5_0_5b (smoke scale)",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "generated_by": "tools/torch_perf_smoke.py",
        "prefill": {"baseline": base_p, "overlapped": fast_p,
                    "speedup": round(speedup, 2),
                    "pair_speedups": [round(r, 3) for r in ratios_p]},
        "decode": {"baseline": base_d, "overlapped": fast_d,
                   "tpot_ratio": round(tpot_ratio, 2),
                   "pair_ratios": [round(r, 3) for r in ratios_d]},
        "decode_fusion": {"logits": logits_row, "fused": fused_row,
                          "fused_tpot_ratio": round(fused_ratio, 2),
                          "pair_ratios": [round(r, 3) for r in ratios_f],
                          "streams_identical": same_f},
        "kv_tier": tier_rows,
        "disagg": disagg_row,
        "spec": spec_row,
        "streams_identical": (same_p and same_d and same_f
                              and tier_rows["streams_identical"]
                              and disagg_row["streams_identical"]
                              and spec_row["streams_identical"]),
        "gates": {"min_prefill_speedup": args.min_speedup,
                  "max_tpot_ratio": args.max_tpot_ratio,
                  "max_fused_ratio": args.max_fused_ratio,
                  "passed": not failures},
    }
    return payload, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min-speedup", type=float, default=1.1,
                    help="gate on the packed + overlapped prefill "
                         "throughput over the per-request baseline")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=160)
    ap.add_argument("--decode-len", type=int, default=8,
                    help="output length of the decode-TPOT trace")
    ap.add_argument("--max-tpot-ratio", type=float, default=1.3,
                    help="gate: overlapped decode TPOT over baseline")
    ap.add_argument("--max-fused-ratio", type=float, default=1.2,
                    help="gate: fused decode TPOT over the logits path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_perf_smoke.json"),
                    help="where the JSON payload is written")
    args = ap.parse_args(argv)

    payload, failures = collect(args)
    print(json.dumps(payload, indent=1))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1) + "\n")
    print(f"wrote {out}")
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    if failures:
        return 1
    print(f"OK: {payload['prefill']['speedup']:.2f}x prefill throughput, "
          f"decode TPOT ratio {payload['decode']['tpot_ratio']:.2f}x, "
          f"fused decode ratio "
          f"{payload['decode_fusion']['fused_tpot_ratio']:.2f}x, "
          f"spec launch reduction "
          f"{payload['spec']['launch_reduction']:.2f}x, "
          "identical streams (incl. disagg handoff and speculative "
          "decode, sim<->live counter parity), no hidden host syncs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
