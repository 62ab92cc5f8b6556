"""hubert-xlarge — encoder-only audio transformer (w2v2 architecture).

[audio] 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified]

The modality frontend (conv feature extractor) is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings of dim
``frontend_dim``; the model projects them to d_model. Encoder-only: no
causal mask, no KV cache, no decode shapes.
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,               # k-means target codebook (CTC-style head)
    head_dim=80,
    causal=False,
    frontend="audio",
    frontend_dim=512,        # conv feature extractor output dim (stubbed)
    mlp_gated=False,         # w2v2-family: GELU MLP
    source="arXiv:2106.07447; unverified",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="hubert-xlarge-smoke",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=384,
    vocab=64,
    frontend_dim=48,
)
