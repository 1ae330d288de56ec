"""The fused decode's CUDA-graph cache (``model_exec.DecodeGraphs``) as far
as the CPU sees it: the table width rule, the launch recording that keeps
``ops.launch_counts()`` exact across replays, and a CPU engine that never
captures (no graphs, both counters 0, no ``model_exec.capture`` span,
``graph=0`` on its decode launch spans) and serves the greedy streams.
The graphs themselves run on the card: ``tests/test_torch_gpu.py``."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.core import SLO, EngineConfig, Request, make_policy
from repro_torch.kernels import build
from repro_torch.models.model import greedy_generate, init_params
from repro_torch.serving import Engine, model_exec

CFG = get_smoke("qwen1_5_0_5b")
PARAMS = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("width, widest, want", [
    (64, 1, 64), (64, 63, 64), (64, 64, 64),        # fits: kept
    (64, 65, 96), (64, 97, 128), (64, 130, 192),     # the row's bucket
    (192, 130, 192), (192, 160, 192),                # never shrinks
    (192, 193, 256), (4, 5, 6)])
def test_the_width_only_grows_to_the_widest_rows_bucket(width, widest,
                                                        want):
    got = model_exec.grown_width(width, widest)
    assert got == want >= width
    assert got == (width if widest <= width
                   else model_exec.table_bucket(widest))


def test_widths_along_a_growing_sequence_follow_table_bucket():
    """A request growing a block at a time from a 1024-token max_ctx
    (64 blocks): the width moves only where a row first passes it."""
    width, seen = model_exec.table_bucket(-(-1024 // 16)), []
    for widest in range(1, 200):
        new = model_exec.grown_width(width, widest)
        if new != width:
            seen.append((widest, new))
        width = new
    assert seen == [(65, 96), (97, 128), (129, 192), (193, 256)]


class _Wrapper:
    """Stands in for a kernel wrapper: a function with ``launches``."""
    launches = 0


def test_a_capture_is_recorded_and_counted_once_per_replay():
    w = _Wrapper()
    build.count_launch(w)
    with build.recording() as rec:
        for _ in range(3):
            build.count_launch(w)         # captured: runs nothing
    assert w.launches == 1 and rec == {w: 3}
    for _ in range(4):
        build.add_launches(rec)           # four replays
    assert w.launches == 1 + 4 * 3
    build.count_launch(w)                 # eager again after the capture
    assert w.launches == 14
    build.reset_launches([w])
    assert w.launches == 0


def test_a_recording_sees_only_its_own_threads_launches():
    """The transfer lanes' thread launches while the engine's captures:
    its launches run, and are counted at once."""
    w, other = _Wrapper(), _Wrapper()
    started, done = threading.Event(), threading.Event()

    def lane():
        started.wait()
        build.count_launch(other)
        build.count_launch(w)
        done.set()

    t = threading.Thread(target=lane)
    t.start()
    with build.recording() as rec:
        build.count_launch(w)
        started.set()
        done.wait(10)
    t.join()
    assert rec == {w: 1}
    assert (w.launches, other.launches) == (1, 1)


def test_counts_stay_exact_while_threads_count_and_replay():
    """Sixteen threads at a short switch interval: half count launches
    one by one, half record a two-launch capture and count it as
    replays; no update is lost."""
    w, n = _Wrapper(), 400

    def count():
        for _ in range(n):
            build.count_launch(w)

    def replay():
        with build.recording() as rec:
            build.count_launch(w)
            build.count_launch(w)
        for _ in range(n // 2):
            build.add_launches(rec)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=(count, replay)[i % 2])
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert w.launches == 16 * n


def serve_cpu(**kw):
    eng = Engine(CFG, PARAMS, EngineConfig(eta=1.0, w_p=4.0, tau=1e9),
                 make_policy("slidebatching"), num_blocks=160,
                 block_size=16, max_ctx=256, device="cpu", **kw)
    rng = np.random.default_rng(3)
    reqs = []
    for plen, olen in ((9, 6), (37, 5), (20, 7), (50, 4), (3, 6)):
        r = Request(prompt_len=plen, output_len=olen, arrival=0.0,
                    slo=SLO(3600.0, 3600.0), priority=2)
        prompt = rng.integers(1, CFG.vocab, plen).astype(np.int32)
        eng.add_request(r, prompt)
        reqs.append((r, prompt))
    t0 = time.monotonic()
    eng.run_until_drained()
    spans = [s for s in obs.recorder().spans() if s.t0 >= t0]
    eng.kill()
    return eng, reqs, spans


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "logits"])
def test_a_cpu_engine_never_captures_and_keeps_its_streams(fused):
    eng, reqs, spans = serve_cpu(fused_decode=fused)
    assert eng.graphs is None
    st = eng.stats
    assert st.decode_launches > 0
    assert st.decode_graph_captures == st.decode_graph_replays == 0
    assert "model_exec.capture" not in {s.name for s in spans}
    decode = [s for s in spans if s.name == "model_exec.launch"
              and s.attrs["kind"] == "decode"]
    assert len(decode) == st.decode_launches
    assert all(s.attrs["graph"] == 0 for s in decode)
    for r, prompt in reqs:
        assert eng.outputs[r.rid] == greedy_generate(CFG, PARAMS, prompt,
                                                     r.output_len)
