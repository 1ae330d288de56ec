"""A copy of the benchmark, at smoke size, that tests run on the CPU.

``make(dst)`` copies ``BENCHMARK.json`` and ``bench/`` into ``dst``,
links the program's ``src`` beside them, and ADDS, as new files and
entries only, a configuration, a traffic mix, a cell and two metrics
(one end-to-end, one per-layer): exactly what a later change that extends
the benchmark does.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CHAT = "qwen2_7b.chat"
SMOKE_CHAT = "smoke.chat"

DENSE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=256)
DENSE_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab=256)
READER = '''"""Requests due in the window (a metric added by a test)."""


def read(run):
    return len(run.measured) or None
'''
E2E_READER = '''"""Output tokens received inside the window, a second (a metric
added by a test)."""
from bench import measure


def read(run):
    return measure.window_tokens_per_s(run)
'''


def _config(src: str, sizes: dict, arch: dict, blocks: int) -> dict:
    c = json.loads((ROOT / "bench" / "configs" / src).read_text())
    c.update(sizes)
    c["program"]["overrides"].update(arch)
    c["serve"]["num_blocks"] = blocks
    c["check"].update(min_tokens=20)
    return c


def make(dst: Path) -> Path:
    dst = Path(dst)
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "src").symlink_to(ROOT / "src")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = dst / "bench" / "configs"
    (cfgs / "smoke_dense.json").write_text(json.dumps(
        _config("qwen2_7b_fp32.json", DENSE, DENSE_ARCH, 400)))
    mixes = dst / "bench" / "traffic"
    chat = json.loads((mixes / "chat.json").read_text())
    chat.update(rate_per_s=12.0, ramp_s=0.5, drain_limit_s=20.0,
                prompt_tokens={"mean": 48, "sigma": 0.6, "min": 8,
                               "max": 96},
                output_tokens={"mean": 8, "sigma": 0.5, "min": 4, "max": 16},
                shared_prefixes={"share": 0.5, "count": 2, "tokens": 32,
                                 "min_prompt": 40},
                warmup={"requests": 3, "output_tokens": 4})
    (mixes / "smoke_chat.json").write_text(json.dumps(chat))
    (dst / "bench" / "metrics" / "smoke.requests_due.py").write_text(READER)
    (dst / "bench" / "metrics" / "smoke.tokens_per_s.py").write_text(
        E2E_READER)
    conf = {c["name"]: c for c in b["configs"]}
    b["configs"].append(dict(conf["qwen2_7b_fp32"], name="smoke_dense",
                             file="bench/configs/smoke_dense.json"))
    cells = {w["name"]: w for w in b["workloads"]}
    b["workloads"].append(dict(cells[CHAT], name=SMOKE_CHAT,
                               config="smoke_dense", traffic="smoke_chat"))
    for m in b["end_to_end"] + b["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and CHAT in ws:
            ws.append(SMOKE_CHAT)
    b["end_to_end"].append({"name": "smoke.tokens_per_s",
                            "unit": "tokens/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": [SMOKE_CHAT]})
    b["per_layer"].append({"name": "smoke.requests_due", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "front end", "moves": "tdg_ratio",
                           "workloads": [SMOKE_CHAT]})
    (dst / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dst
