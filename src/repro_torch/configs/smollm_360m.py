"""smollm-360m — llama-arch small dense LM.

[dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    mlp_gated=True,          # llama family: SwiGLU
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="smollm-360m-smoke",
    n_layers=3,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab=512,
)
