"""A copy of the benchmark, at smoke size, that tests run on the CPU.

``make(dst)`` copies ``BENCHMARK.json`` and ``bench/`` into ``dst``,
links the program's ``src`` beside them, and ADDS, as new files and
entries only, a dense configuration, a traffic mix, a cell and two
metrics (one end-to-end, one per-layer), and a routed-expert (MoE)
configuration with its own reference, mix and cell: exactly what a later
change that extends the benchmark does.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CHAT = "qwen2_7b.chat"
SMOKE_CHAT = "smoke.chat"
SMOKE_MOE = "smoke.moe"

DENSE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=256)
DENSE_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab=256)
# the port's olmoe_1b_7b SMOKE widths: 8 experts, top-2, capacity factor
# E / k = 4, so no slot is dropped
MOE = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
           num_key_value_heads=4, head_dim=16, intermediate_size=32,
           vocab_size=256, num_experts=8, num_experts_per_tok=2)
MOE_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=32, d_expert=32, n_experts=8, top_k=2,
                vocab=256, capacity_factor=4.0)
# a reference of the port's present routing and QK-norm, as a later
# configuration brings its own
MOE_REFERENCE = '''"""A routed decoder in OLMoE's layout (QK-norm, routed experts)."""
import torch

from .common import routed_ffn, run


@torch.no_grad()
def logits(spec, w, tokens, rows):
    m = w["layers"]["moe"]
    return run(spec, w, tokens, rows,
               lambda li, h: routed_ffn(spec, m, li, h))
'''
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


def moe_config() -> dict:
    """The smoke MoE configuration file: published OLMoE keys at the
    port's SMOKE widths, checked by the routed rule."""
    return dict(
        source="https://huggingface.co/allenai/OLMoE-1B-7B-0924/blob/main/"
               "config.json",
        **MOE, rms_norm_eps=1e-06, rope_theta=10000.0, qkv_bias=False,
        qk_norm=True, norm_topk_prob=True, dtype="float32", tf32=False,
        reference="smoke_moe",
        program={"arch": "olmoe_1b_7b", "overrides": dict(MOE_ARCH),
                 "fields": {"num_experts": "n_experts",
                            "num_experts_per_tok": "top_k"}},
        serve={"num_blocks": 400, "block_size": 16, "max_seqs": 256},
        check={"rule": "routed", "gap_tol": 1e-3, "max_departing_share": 0.12,
               "min_requests": 8, "min_tokens": 20, "sample_tokens": 1500,
               "sample_requests": 12, "include": [],
               "why": {"gap_tol": "fp32 rounding at a near-tie of the "
                                  "vocabulary; the dense rule's limit",
                       "max_departing_share": "the value set at full "
                                              "width from the card's "
                                              "readings (PERF.md)",
                       "min_requests": "a mean over enough requests to "
                                       "dilute one that departs",
                       "min_tokens": "the smoke cell's sample"}},
        assumed=["norm_topk_prob true and QK-norm per head: the port's "
                 "present routing and norm, which the reference follows",
                 "rms_norm_eps 1e-06: the port's fixed epsilon"])


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
    (cfgs / "smoke_moe.json").write_text(json.dumps(moe_config()))
    (dst / "bench" / "reference" / "smoke_moe.py").write_text(MOE_REFERENCE)
    decode = dict(chat, output_tokens={"mean": 16, "sigma": 0.5, "min": 8,
                                       "max": 32})
    del decode["shared_prefixes"]
    (mixes / "smoke_decode.json").write_text(json.dumps(decode))
    (dst / "bench" / "metrics" / "smoke.requests_due.py").write_text(READER)
    (dst / "bench" / "metrics" / "smoke.tokens_per_s.py").write_text(
        E2E_READER)
    conf = {c["name"]: c for c in b["configs"]}
    b["configs"].append(dict(conf["qwen2_7b_fp32"], name="smoke_dense",
                             file="bench/configs/smoke_dense.json"))
    b["configs"].append(dict(conf["qwen2_7b_fp32"], name="smoke_moe",
                             file="bench/configs/smoke_moe.json"))
    cells = {w["name"]: w for w in b["workloads"]}
    b["workloads"].append(dict(cells[CHAT], name=SMOKE_CHAT,
                               config="smoke_dense", traffic="smoke_chat"))
    b["workloads"].append(dict(cells[CHAT], name=SMOKE_MOE,
                               config="smoke_moe", traffic="smoke_decode"))
    for m in b["end_to_end"] + b["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and CHAT in ws:
            ws += [SMOKE_CHAT, SMOKE_MOE]
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
