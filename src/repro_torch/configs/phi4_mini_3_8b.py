"""Phi-4-mini-3.8B [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064,
RoPE (partial 0.75) + SwiGLU + GQA.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
    rope_fraction=0.75,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256)
