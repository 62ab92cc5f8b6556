"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7 interleave) with MoE.

[hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf]

Layer pattern (per arXiv:2403.19887): blocks of 8 layers, 1 attention + 7
Mamba; MoE replaces the MLP on every other layer (moe_every=2).
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,              # dense-MLP layers inner dim
    vocab=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,          # expert inner dim
    moe_every=2,
    moe_offset=1,
    attn_every=8,            # 1 attention layer per 8 (rest Mamba)
    ssm_d_state=16,
    ssm_conv=4,
    ssm_expand=2,
    mlp_gated=True,
    source="arXiv:2403.19887; hf",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="jamba-1.5-large-smoke",
    n_layers=8,              # one full super-block: 1 attn + 7 mamba
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    moe_d_ff=256,
    n_experts=4,
    top_k=2,
    vocab=512,
    ssm_d_state=8,
)
