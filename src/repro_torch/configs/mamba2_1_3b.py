"""Mamba2-1.3B [arXiv:2405.21060; unverified].

48L d_model=2048, attention-free SSD (state-space duality), ssm_state=128,
d_inner=4096, head_dim=64 (64 ssm heads), vocab=50280.
Constant per-request state => long_500k decode RUNS.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, head_dim=64,
    ssm_state=128, ssm_head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, vocab=256)
