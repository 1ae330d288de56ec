"""Chameleon-34B [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Early-fusion VLM:
VQ image tokens are ordinary ids in the 65536 vocab, so the backbone is a
pure decoder; the modality frontend is a stub (input_specs supplies token
ids).  QK-norm per the paper's training-stability fix.
"""
import dataclasses
from ..models.model import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, head_dim=128,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256)
