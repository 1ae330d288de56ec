"""One run of one cell: the system under test built as its users run it,
an open-loop arrival schedule driven through its front end, the end-to-end
and per-layer metrics read by name, and the check that decides
``correct``.

The path: ``ServiceFrontend.submit`` (GoRouting, ``pd_mode="coloc"``, as
``repro_torch.launch.serve.serve_frontend`` builds it) over one
``Engine`` on its ``EngineDriver`` thread, SlideBatching at
``EngineConfig``'s defaults with ``w_p = serve.W_P``, packed prefill and
fused decode on the hand-written kernels, the paged pool, the radix
prefix cache and the transfer lanes on, ``FrontendConfig`` at its
defaults (a request refused at admission counts as failed).

Everything a cell needs is found by name: the cell and its metrics in
``BENCHMARK.json``, the configuration in the file it names, the mix in
``bench/traffic/<traffic>.json``, each metric's reader in
``bench/metrics/<metric>.py``, the reference in
``bench/reference/<reference>.py``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from . import check, traffic
from .trace import Instruments
from .weights import make_weights, nbytes

ROOT = Path(__file__).resolve().parents[1]
LEAD_S = 0.5          # from the start of submission to the first arrival
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def program(root: Path = ROOT):
    """The system under test: ``repro_torch`` from the checkout's ``src``."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return importlib.import_module("repro_torch")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                  # the cell's entry in BENCHMARK.json
    config: dict                 # the configuration file
    mix: dict                    # the traffic file
    end_to_end: list             # metric entries this cell reports
    per_layer: list
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = traffic.load(root / "bench" / "traffic" / f"{entry['traffic']}.json")

    def mine(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) in (None, True)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if mine(m) or (mine(m) is None and m["moves"] in e2e_names)]
    return Cell(name, entry, config, mix, e2e, per, root)


# published keys every decoder's file may give, and the ArchConfig field
# each is checked against
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab",
          "head_dim": "hd", "rope_theta": "rope_theta",
          "qkv_bias": "qkv_bias", "qk_norm": "qk_norm",
          "intermediate_size": "d_ff"}


def build_arch(config: dict, root: Path = ROOT):
    """The program's ``ArchConfig``: its config module's published widths
    with the file's ``program.overrides``, checked against the file's
    published keys: those of ``FIELDS`` that the file gives, and every
    pair of ``program.fields`` ({published key: ArchConfig field}), which
    the file must give.  In a routed model ``intermediate_size`` is one
    expert's width, unless the file gives ``moe_intermediate_size``."""
    program(root)
    from repro_torch.configs import get
    prog = config["program"]
    arch = dataclasses.replace(get(prog["arch"]), **prog.get("overrides", {}))
    fields = {k: v for k, v in FIELDS.items() if k in config}
    if arch.family == "moe":
        if "moe_intermediate_size" in config:
            fields.pop("intermediate_size", None)
        elif "intermediate_size" in fields:
            fields["intermediate_size"] = "d_expert"
    listed = prog.get("fields", {})
    lacking = [f for f in listed.values() if not hasattr(arch, f)]
    unstated = [k for k in listed if k not in config]
    if lacking or unstated:
        raise ValueError(f"program.fields names ArchConfig fields it lacks "
                         f"{lacking} or published keys the file lacks "
                         f"{unstated}")
    fields.update(listed)
    bad = {k: (config[k], getattr(arch, f)) for k, f in fields.items()
           if config[k] != getattr(arch, f)}
    if bad:
        raise ValueError(f"the program's config differs from the file: "
                         f"{bad}")
    return arch


@dataclasses.dataclass
class Rec:
    """One submitted request as its client saw it (absolute monotonic
    seconds)."""
    planned: traffic.Planned
    req: object                  # the program's Request
    arrival: float               # due time
    submitted: float = math.nan
    out_times: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    error: Optional[str] = None  # refused at admission or stream error
    hit_tokens: int = 0

    # the fields the frozen TDG arithmetic reads
    @property
    def ttft_s(self):
        return self.planned.ttft_s

    @property
    def tpot_s(self):
        return self.planned.tpot_s

    @property
    def weight(self):
        return self.planned.weight

    @property
    def output_len(self):
        return self.planned.output_len

    @property
    def complete(self) -> bool:
        return self.error is None and len(self.tokens) >= self.output_len

    failed: bool = False


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    seed: int
    seconds: float
    arch: object
    device: torch.device
    recs: list
    window: tuple                # (start, end), absolute monotonic
    setup_s: float
    counters: dict               # EngineStats fields over the window
    inst: object = None          # trace.Instruments
    prof: object = None          # trace.DeviceTrace (trace runs on a card)
    peaks: Optional[dict] = None
    kernels: dict = dataclasses.field(default_factory=dict)  # the library
    pool: tuple = (0, 0)         # (blocks, bytes a block) of the paged pool
    queue: list = dataclasses.field(default_factory=list)  # (t, queued,
    # running) each second, t from the window's start

    @property
    def measured(self) -> list:
        return [r for r in self.recs if r.planned.measured]


_STAT_KEYS = ("iterations", "tokens_out", "prefill_tokens", "evictions",
              "reload_blocks", "cache_hit_tokens", "offload_blocks",
              "staged_hits", "staged_misses", "host_syncs",
              "decode_launches", "packed_prefill_calls", "cow_forks",
              "decode_graph_captures", "decode_graph_replays")


def _stats(eng) -> dict:
    return {k: getattr(eng.stats, k) for k in _STAT_KEYS}


def load_kernels(dev) -> dict:
    """Set-up: the port's kernel library, built with nvcc into the
    checkout's ``build/kernels/`` by the first run there and loaded by
    every later one.  Its time is part of ``setup_s`` and is also
    recorded apart here."""
    if dev.type != "cuda":
        return {}
    from repro_torch.kernels import build
    built = not build.is_current()
    t0 = time.monotonic()
    build.library()
    return {"built": built, "seconds": time.monotonic() - t0}


def build_system(arch, weights, config: dict, device):
    """The system under test, as ``launch/serve.py`` ``serve_frontend``
    builds it, over one engine whose clock is the front end's."""
    from repro_torch.core import (EngineConfig, GoRouting, RouterConfig,
                                  make_policy)
    from repro_torch.core.estimator import BatchLatencyEstimator
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.frontend import FrontendConfig, ServiceFrontend
    est = BatchLatencyEstimator(**serve.ROUTER_EST)
    fe = ServiceFrontend(GoRouting(est, RouterConfig(pd_mode="coloc")), est,
                         FrontendConfig())
    sv = config["serve"]
    eng = Engine(arch, weights,
                 EngineConfig(w_p=serve.W_P, max_seqs=sv["max_seqs"]),
                 make_policy("slidebatching"), num_blocks=sv["num_blocks"],
                 block_size=sv["block_size"], device=device)
    eng.use_wall_clock(fe._epoch)
    return fe, eng


def warm_up(eng, mix: dict, vocab: int, seed: int) -> int:
    """Set-up's warm-up: the mix's warm-up requests served to the end on
    the engine itself, before its driver starts."""
    from repro_torch.core import SLO, Request
    for prompt, olen in traffic.warmup_set(mix, vocab, seed):
        eng.add_request(Request(prompt_len=len(prompt), output_len=olen,
                                arrival=eng.now, slo=SLO(60.0, 60.0),
                                priority=3, weight=1.0), prompt)
    steps = 0
    while eng.has_work() and steps < 100000:
        eng.step()
        steps += 1
    eng.flush_transfers()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return steps


async def drive(fe, eng, sched: list, mix: dict, seconds: float,
                inst=None) -> tuple:
    """Submit the schedule on time, consume every stream at the client
    edge, and go on submitting after the window until every request due
    in it has finished or the drain limit is reached.  Returns (records,
    window, stats at the window's start and end, first arrival)."""
    from repro_torch.core import SLO, Request
    from repro_torch.serving.frontend import AdmissionError
    await fe.start()
    epoch = fe._epoch
    origin = time.monotonic() + LEAD_S + float(mix["ramp_s"])  # window start
    w_end = origin + seconds
    stop_at = w_end + float(mix["drain_limit_s"])
    pending = {p.idx for p in sched if p.measured}
    all_done = asyncio.Event()
    if not pending:
        all_done.set()
    recs, tasks, marks = [], [], {}

    async def consume(rec, stream):
        try:
            async for _ in stream:
                pass
        except Exception as exc:              # a driver died: the stream
            rec.error = repr(exc)             # is closed with its error
        rec.out_times = list(stream.recv_times)
        rec.tokens = list(stream.tokens)
        if rec.planned.measured:
            pending.discard(rec.planned.idx)
            if not pending:
                all_done.set()

    async def probe():
        """Every second: the engine's queue and its running requests."""
        while True:
            q = eng.queue
            marks.setdefault("queue", []).append(
                (round(time.monotonic() - origin, 3), len(q),
                 sum(1 for r in q if r.generated > 0)))
            await asyncio.sleep(1.0)

    async def window_marks():
        await asyncio.sleep(max(0.0, origin - time.monotonic()))
        marks["start"] = _stats(eng)
        if inst is not None:
            await inst.start_slice(w_end)
        await asyncio.sleep(max(0.0, w_end - time.monotonic()))
        marks["end"] = _stats(eng)
        if inst is not None:
            inst.end_slice()

    marker = asyncio.ensure_future(window_marks())
    prober = asyncio.ensure_future(probe())
    try:
        for p in sched:
            due = origin + p.due
            if due >= stop_at or (p.segment == "after"
                                  and all_done.is_set()):
                break
            delay = due - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            if p.segment == "after" and all_done.is_set():
                break
            req = Request(prompt_len=len(p.prompt), output_len=p.output_len,
                          arrival=due - epoch, slo=SLO(p.ttft_s, p.tpot_s),
                          priority=p.priority, weight=p.weight)
            rec = Rec(p, req, due)
            recs.append(rec)
            try:
                stream = await fe.submit(req, p.prompt, stamp_arrival=False)
            except AdmissionError as exc:
                rec.error = f"refused: {exc}"
                rec.submitted = time.monotonic()
                if p.measured:
                    pending.discard(p.idx)
                    if not pending:
                        all_done.set()
                continue
            rec.submitted = time.monotonic()
            tasks.append(asyncio.ensure_future(consume(rec, stream)))
        try:
            await asyncio.wait_for(all_done.wait(),
                                   max(0.0, stop_at - time.monotonic()))
        except asyncio.TimeoutError:
            pass
        await marker
    finally:
        prober.cancel()
        if not marker.done():
            marker.cancel()
        await fe.stop()
        await asyncio.gather(*tasks, return_exceptions=True)
    first = origin + sched[0].due if sched else origin
    return recs, (origin, w_end), marks, first


def jax_loaded() -> list:
    """Top-level modules of this process that must not be there."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(root: Path, name: str):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        v = load_reader(run.cell.root, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", root: Path = ROOT,
             rate: Optional[float] = None, do_check: bool = True,
             log=print) -> dict:
    """One run; returns the result's fields (and ``run``, the raw data)."""
    cell = load_cell(name, root)
    if rate is not None:
        cell.mix = dict(cell.mix, rate_per_s=rate)
    dev = torch.device(device)
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    arch = build_arch(cell.config, root)
    kernels = load_kernels(dev)
    weights = make_weights(arch, seed, dev)
    fe, eng = build_system(arch, weights, cell.config, dev)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        log(f"set-up: weights {nbytes(weights) / 2**30:.3f} GiB, pool "
            f"{cell.config['serve']['num_blocks']} blocks = "
            f"{eng.pool.kv.numel() * eng.pool.kv.element_size() / 2**30:.3f}"
            f" GiB; mem_get_info free {free / 2**30:.3f} / "
            f"{total / 2**30:.3f} GiB")
    warm = warm_up(eng, cell.mix, arch.vocab, seed)
    fe.add_instance(eng)
    inst = Instruments(eng, arch)
    inst.install()
    if trace and dev.type == "cuda":
        inst.prepare_profiler()
    sched = traffic.schedule(cell.mix, seconds, arch.vocab, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        recs, window, marks, first = asyncio.run(
            drive(fe, eng, sched, cell.mix, seconds, inst))
    finally:
        inst.end_slice()
        inst.uninstall()
        eng.kill()
        inst.stop_profiler()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    for rec in recs:
        rec.failed = rec.error is not None or (
            rec.planned.measured and not rec.complete)
        rec.hit_tokens = inst.hits.get(rec.req.rid, 0)
    counters = {k: marks.get("end", {}).get(k, 0)
                - marks.get("start", {}).get(k, 0) for k in _STAT_KEYS}
    run = Run(cell, seed, seconds, arch, dev, recs, window,
              first - t_start, counters, inst, queue=marks.get("queue", []))
    run.kernels = kernels
    run.pool = (eng.pool.num_blocks, eng.pool.kv.numel()
                * eng.pool.kv.element_size() // eng.pool.num_blocks)
    if trace:
        run.prof = inst.device_trace()
        run.peaks = _peaks(root, dev)
    bad = jax_loaded()
    # the program's state goes before the reference runs
    del fe, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    result = {"run": run, "metrics": metrics, "peak": peak,
              "forbidden": bad, "warmup_steps": warm}
    if do_check:
        result["check"] = check.check(cell, run, weights, seed, log=log)
    else:
        result["weights"] = weights
    return result


def _peaks(root: Path, dev) -> Optional[dict]:
    if dev.type != "cuda":
        return None
    table = json.loads((root / "bench" / "peaks.json").read_text())
    return table.get(torch.cuda.get_device_name(dev))


def info(run: Run, res: dict) -> dict:
    """What the run saw beside its metrics: counts, the tails and gain
    over the requests due in the window (judged only in a cell below
    capacity), the engine's counters over the window, set-up."""
    from . import measure
    meas = run.measured
    late = measure.late_ms(run)
    out = {
        "cell": run.cell.name, "seed": run.seed, "seconds": run.seconds,
        "rate_per_s": run.cell.mix["rate_per_s"],
        "submitted": len(run.recs), "measured": len(meas),
        "refused": sum(1 for r in run.recs if r.error
                       and r.error.startswith("refused")),
        "errored": sum(1 for r in run.recs if r.error
                       and not r.error.startswith("refused")),
        "measured_unfinished": sum(1 for r in meas if not r.complete),
        "tdg_ratio": measure.tdg(run),
        "ttft_p50_s": measure.p50(measure.ttfts(run)),
        "ttft_p95_s": measure.p95(measure.ttfts(run), measure.cap_s(run)),
        "tpot_p50_s": measure.p50(measure.tpots(run)),
        "tpot_p95_s": measure.p95(measure.tpots(run), measure.cap_s(run)),
        "slo_met_share": measure.slo_met(run),
        "output_tokens_per_s": measure.window_tokens_per_s(run),
        "late_p95_ms": measure.p95(late, 1e3 * measure.cap_s(run)),
        "setup_s": run.setup_s, "warmup_steps": res["warmup_steps"],
        # the kernel library: built by this run, and its part of setup_s
        "kernel_library": run.kernels,
        "window_counters": run.counters,
        # Engine.step calls inside the window, those that formed no batch
        # (the driver then parks 2 ms), and the host time those took
        "step_calls": measure.span_count(run, "steps"),
        "empty_steps": measure.span_count(run, "empty_steps"),
        "empty_step_ms": measure.spans_ms(run, "empty_steps"),
        "memory_peak_bytes": res["peak"],
        # the pool's blocks that held data at the fullest step of the
        # window, beside the blocks it reserves
        "pool_blocks": run.pool[0],
        "pool_blocks_peak": measure.pool_peak(run),
        "pool_bytes_peak": (measure.pool_peak(run) or 0) * run.pool[1],
        "queue_each_s": run.queue,
        "by_class": measure.by_class(run),
        # each measured request's client-edge TTFT and TPOT (inf: failed)
        "ttft_s": [round(x, 6) if math.isfinite(x) else None
                   for x in measure.ttfts(run)],
        "tpot_s": [round(x, 6) if math.isfinite(x) else None
                   for x in measure.tpots(run)],
    }
    # the per-layer metrics read on the host clock, in every run: beside
    # a traced run's, the same readings without the profiler
    out["per_layer_host"] = {
        k: v["value"] for k, v in read_metrics(
            run, [m for m in run.cell.per_layer
                  if m["source"] != "device_trace"]).items()}
    if "check" in res:
        out["check_readings"] = res["check"]["readings"]
        out["check_seconds"] = res["check"]["seconds"]
    # host time the profiler's start held the event loop, and its stop
    # (after the engine stopped) took
    out["profiler_start_s"] = [b - a for a, b in run.inst.stalls]
    out["profiler_stop_s"] = run.inst.stop_s
    if run.prof is not None:
        out["trace_reduce_s"] = run.prof.reduce_s
        out["profiled_slice_s"] = run.prof.wall_s
        out["marker_offset_us"] = run.prof.offset_us
        out["marker_skew_us"] = run.prof.marker_skew_us
        # launches the wrappers saw in the slice beside the kernels the
        # profiler recorded: a check that the trace holds every launch
        out["slice_launches"] = {
            name: [run.inst.calls.get(name, 0),
                   measure.kernel_time(run, needle)[1]]
            for name, needle in (("paged_decode_attention",
                                  "paged_decode_kernel"),
                                 ("packed_prefill_attention",
                                  "packed_prefill_kernel"))}
    return out
