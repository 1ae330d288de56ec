"""ChatGLM3-6B [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
2D-RoPE = rotary on HALF the head dims (rope_fraction=0.5); QKV bias.
kv=2 < 16-way TP => decode uses the sequence-sharded flash-decode path.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128,
    qkv_bias=True, rope_fraction=0.5,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256)
