"""The port's runnable entry points of the service tier on the CPU: the
four examples (``python -m repro_torch.examples.X --smoke --device
cpu``), the replay CLI's frontend mode, and ``tools/torch_perf_smoke.py``
(host syncs, identical streams, and the live/sim counter parity for the
tiered store, disaggregation and speculation)."""
import json
import runpy
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_example_runs_the_simulator():
    from repro_torch.examples import quickstart
    rows = quickstart.main(["--smoke"])
    assert set(rows) == {"slidebatching", "sarathi_fcfs"}
    assert all(0.0 <= s.tdg_ratio <= 1.0 for s in rows.values())


def test_serve_cluster_example_on_cpu():
    from repro_torch.examples import serve_cluster
    out = serve_cluster.main(["--smoke", "--device", "cpu"])
    rep = out["report"]
    assert rep.n_completed == rep.n_submitted == 8
    assert sum(e.stats.tokens_out for e in out["frontend"].engines.values()
               ) == 8 * 2


def test_shared_prefix_example_on_cpu():
    from repro_torch.examples import shared_prefix
    res = shared_prefix.main(["--smoke", "--device", "cpu"])
    assert res[True]["completed"] == res[False]["completed"] == "8/8"
    assert res[False]["cache_hit_tokens"] == 0


def test_priority_serving_example_streams_are_greedy_on_cpu():
    """The example preempts in a 20-block pool; every stream equals
    uninterrupted greedy decoding of its prompt, recomputed here."""
    from repro_torch.examples import priority_serving
    from repro_torch.models.model import greedy_generate
    out = priority_serving.main(["--smoke", "--device", "cpu"])
    eng, reqs = out["engine"], out["requests"]
    assert len(reqs) == 8 and eng.stats.evictions > 0
    assert sum(r.preemptions for r, _ in reqs) > 0
    for r, prompt in reqs:
        assert eng.outputs[r.rid] == greedy_generate(
            out["cfg"], out["params"], prompt, 4)
    assert all(out["exact"].values())
    assert 0.0 <= out["tdg_ratio"] <= 1.0


def test_replay_cli_frontend_mode_on_cpu(capsys):
    from repro_torch.sim import replay
    replay._main(["--workload", "industrial", "--mode", "frontend",
                  "--rate", "8", "--duration", "1", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out)
    assert row["submitted"] == row["completed"] > 0
    assert row["rejected"] == 0


def test_torch_perf_smoke_gates_pass_on_cpu(tmp_path):
    """The tool's gates at the reference's thresholds on the CPU.  Each
    speed gate reads the median of the ratios of adjacent pairs of timed
    passes (the pair's order alternating), so the load of whatever else
    runs on the machine reaches both sides of every ratio; on the CPU the
    fused and logits paths do the same work, a ratio of ~1.0."""
    tool = runpy.run_path(str(ROOT / "tools" / "torch_perf_smoke.py"),
                          run_name="torch_perf_smoke")
    out = tmp_path / "perf.json"
    rc = tool["main"](["--device", "cpu", "--requests", "6",
                       "--prompt-len", "48", "--decode-len", "4",
                       "--out", str(out)])
    payload = json.loads(out.read_text())
    assert rc == 0 and payload["gates"]["passed"]
    # the reference's speed gates, on by default
    assert (payload["gates"]["min_prefill_speedup"],
            payload["gates"]["max_tpot_ratio"],
            payload["gates"]["max_fused_ratio"]) == (1.1, 1.3, 1.2)
    assert len(payload["decode_fusion"]["pair_ratios"]) == tool["REPEATS"]
    assert payload["streams_identical"]
    assert payload["disagg"]["parity"] and payload["spec"]["parity"]
    for section in ("prefill", "decode"):
        for row in payload[section].values():
            if isinstance(row, dict):
                assert row["hot_loop_fetches_ok"]


def test_frontend_mode_rejects_int8_handoff():
    """``--mode frontend`` hands KV off in fp32: the int8 wire is a
    ``--pd disagg`` option of the synchronous fleet only."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--mode", "frontend", "--smoke", "--device", "cpu",
                    "--pd", "disagg", "--handoff-int8"])
