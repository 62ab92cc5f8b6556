"""pixtral-12b — VLM: pixtral-ViT frontend (stubbed) + mistral-nemo decoder.

[vlm] 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

The ViT frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (frontend_dim = pixtral vision hidden 1024),
projected into the first ``n_patches`` sequence positions; the remaining
positions are text tokens.
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    frontend="vision",
    frontend_dim=1024,       # pixtral ViT hidden size (stubbed)
    n_patches=256,           # patches prepended to the sequence
    mlp_gated=True,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="pixtral-12b-smoke",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab=512,
    frontend_dim=64,
    n_patches=8,
)
