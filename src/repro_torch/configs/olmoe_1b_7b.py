"""OLMoE-1B-7B [arXiv:2409.02060; hf] as the JAX reference renders it.

16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024 vocab=50304,
MoE: 64 routed experts, top-8, no shared experts.  QK-norm per head,
the top-8 gates renormalised and RMSNorm epsilon 1e-6, as the reference
computes them; the published model is ``olmoe_1b_7b_0924``.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, head_dim=128,
    n_experts=64, n_shared=0, top_k=8, d_expert=1024,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, d_expert=32, n_experts=8, top_k=2, vocab=256,
    capacity_factor=4.0)  # = E/k: provably dropless at smoke scale
