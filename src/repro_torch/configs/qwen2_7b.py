"""Qwen2-7B — the paper's small evaluation model (§5.1)."""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256)
