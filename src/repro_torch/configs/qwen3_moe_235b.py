"""qwen3-moe-235b-a22b — 128-expert top-8 MoE (paper's second eval model).

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,                  # every layer MoE
    vocab=151936,
    head_dim=128,            # qwen3 uses head_dim 128 (64H × 128 = 8192 > d_model)
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    moe_every=1,
    mlp_gated=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen3-moe-235b-smoke",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    n_experts=8,
    top_k=2,
    moe_d_ff=96,
    vocab=512,
)
