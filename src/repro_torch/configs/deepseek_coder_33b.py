"""DeepSeek-Coder-33B [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 — llama architecture
(RMSNorm, SwiGLU, RoPE).
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256)
