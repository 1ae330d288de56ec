"""Whisper-small [arXiv:2212.04356; unverified].

Encoder-decoder: 12+12L d_model=768 12H d_ff=3072 vocab=51865.
LayerNorm + GELU, sinusoidal positions.  The conv audio frontend is a STUB:
``input_specs()`` supplies precomputed (batch, 1500, 768) frame embeddings.
Enc-dec (not encoder-only) => decode shapes RUN (DESIGN.md §4).
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    enc_frames=1500, rope_fraction=0.0, norm="layernorm", act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, enc_frames=32)
