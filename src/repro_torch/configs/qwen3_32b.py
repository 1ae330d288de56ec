"""Qwen3-32B — the paper's large evaluation model (§5.1, §5.6)."""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256)
