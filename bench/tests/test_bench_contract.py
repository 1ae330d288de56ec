"""BENCHMARK.json against the rules of its format, and every
name it holds found as a file."""
from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51
    assert B["paths"] == ["bench"] and B["command"][1] == "bench/run.py"


def test_names_units_and_entries():
    metrics = B["end_to_end"] + B["per_layer"]
    for group in (B["configs"], B["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_has_its_files_and_reports_enough():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for w in B["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        mine = [m for m in B["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layers = [m for m in B["per_layer"] if w["name"] in m["workloads"]]
        assert layers
        for m in layers:
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                    [w["name"]])
    for m in B["end_to_end"] + B["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


def test_shares_of_a_peak_are_named_so():
    for m in B["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
