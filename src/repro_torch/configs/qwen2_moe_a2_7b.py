"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=151936,
MoE: 4 shared + 60 routed experts, top-4.  QKV bias (Qwen1.5 family).
60 routed experts are padded to 64 at sharding time for even EP over the
16-way model axis (dispatch masks the 4 dummies) — see distributed/sharding.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    n_experts=60, n_shared=4, top_k=4, d_expert=1408,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, d_expert=32, n_experts=8, n_shared=1, top_k=2, vocab=256,
    capacity_factor=4.0)  # = E/k: provably dropless at smoke scale
