"""gemma3-4b — dense LM with 5:1 local:global attention, 128k context.

[dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,            # gemma3 uses wide heads
    window=1024,             # sliding-window for local layers
    global_every=6,          # 5 local : 1 global
    mlp_gated=True,          # GeGLU-family gated MLP
    rope_theta=1_000_000.0,  # long-context rope base (global layers)
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="gemma3-4b-smoke",
    n_layers=6,              # one full 5:1 local:global super-block
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab=512,
    window=16,
)
