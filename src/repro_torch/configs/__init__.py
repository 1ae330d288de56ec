"""Assigned architecture configs (--arch <id>).

Each module defines ``CONFIG`` (the exact published configuration) and
``SMOKE`` (a reduced same-family variant for CPU tests).  ``get(name)``
returns the full config, ``get_smoke(name)`` the reduced one.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2_moe_a2_7b",
    "olmoe_1b_7b",
    "whisper_small",
    "mamba2_1_3b",
    "chameleon_34b",
    "hymba_1_5b",
    "deepseek_coder_33b",
    "qwen1_5_0_5b",
    "chatglm3_6b",
    "phi4_mini_3_8b",
    # paper evaluation models (§5.1)
    "qwen2_7b",
    "qwen3_32b",
]

_ALIASES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-small": "whisper_small",
    "mamba2-1.3b": "mamba2_1_3b",
    "chameleon-34b": "chameleon_34b",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "chatglm3-6b": "chatglm3_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-32b": "qwen3_32b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str):
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.CONFIG


def get_smoke(name: str):
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.SMOKE


def all_configs():
    return {n: get(n) for n in ARCH_IDS}
