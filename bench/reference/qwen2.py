"""Qwen2 (dense decoder: GQA with q/k/v bias, rotary, RMSNorm, SwiGLU)."""
from __future__ import annotations

import torch

from .common import run, swiglu


@torch.no_grad()
def logits(spec: dict, w: dict, tokens: torch.Tensor,
           rows: torch.Tensor) -> torch.Tensor:
    m = w["layers"]["mlp"]
    return run(spec, w, tokens, rows,
               lambda li, h: swiglu(h, m["w_gate"][li], m["w_up"][li],
                                    m["w_down"][li]))
