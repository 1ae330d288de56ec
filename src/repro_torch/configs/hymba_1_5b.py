"""Hymba-1.5B [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504, ssm_state=16.  Hybrid-head:
attention heads and SSM heads run in PARALLEL on the same input; outputs
are normalized then averaged.  Sliding-window attention (window=1024) for
all layers (the 3 published full-attention layers are approximated by SWA —
structural deviation noted in DESIGN.md; meta-tokens omitted).
Sub-quadratic => long_500k RUNS.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ssm_state=16, ssm_head_dim=64, window=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, ssm_state=8, ssm_head_dim=16, ssm_chunk=16, window=16,
    vocab=256)
