"""OLMoE (routed decoder, arXiv:2409.02060): QK-norm over the whole q and
k projections, 64 routed experts of which each token takes its 8 of
highest router logit, gated by the softmax over all 64 logits and not
renormalised where ``norm_topk_prob`` is false, RMSNorm at the file's
``rms_norm_eps``, no shared experts.  Plain fp32 torch: matmuls run as the
caller's TF32 setting leaves them, which the harness sets off from the
configuration and the control sets on.

The published modeling code fixes the QK-norm's form (one scale of
``heads * head_dim`` over each projection), and the configuration states
no key for it, so the weights handed in have to carry that form: scales
of any other width raise rather than being normed per head."""
from __future__ import annotations

import torch

from .common import routed_ffn, run


def _whole_projection_norms(spec: dict, attn: dict) -> None:
    hd = spec["head_dim"]
    for name, heads in (("q_norm", spec["num_attention_heads"]),
                        ("k_norm", spec["num_key_value_heads"])):
        width = attn[name].shape[-1]
        if width != heads * hd:
            raise ValueError(
                f"OLMoE norms the whole {name[0]} projection: its scale has "
                f"{heads} * {hd} = {heads * hd} entries, the weights' "
                f"{width}")


@torch.no_grad()
def logits(spec: dict, w: dict, tokens: torch.Tensor,
           rows: torch.Tensor) -> torch.Tensor:
    _whole_projection_norms(spec, w["layers"]["attn"])
    m = w["layers"]["moe"]
    return run(spec, w, tokens, rows,
               lambda li, h: routed_ffn(spec, m, li, h))
