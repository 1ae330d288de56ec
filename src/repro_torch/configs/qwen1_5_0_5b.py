"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936, QKV bias.
Smallest assigned arch — also used for the real CPU serving example.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, head_dim=64,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256)
