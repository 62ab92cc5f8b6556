"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note (DESIGN.md §5): E=40 does not divide the 16-way production model axis —
at that mesh the experts use expert-TP (d_ff sharded); at EP-divisible
meshes (EP ∈ {8, 10, 20, 40}) the full ViBE placement path applies.
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,                  # every layer is MoE
    vocab=49155,
    head_dim=64,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    moe_every=1,
    mlp_gated=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="granite-moe-3b-smoke",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    n_experts=8,
    top_k=2,
    moe_d_ff=64,
    vocab=512,
)
