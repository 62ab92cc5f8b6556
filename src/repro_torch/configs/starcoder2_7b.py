"""starcoder2-7b — dense code LM, GQA + RoPE.

[dense] 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173; hf]
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    mlp_gated=False,         # starcoder2: standard 2-matrix GELU MLP
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173; hf",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="starcoder2-7b-smoke",
    n_layers=3,
    d_model=144,
    n_heads=6,
    n_kv_heads=2,
    head_dim=24,
    d_ff=576,
    vocab=512,
)
