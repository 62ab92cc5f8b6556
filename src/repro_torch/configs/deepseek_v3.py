"""deepseek-v3-671b — the paper's own primary evaluation model.

256 routed experts (top-8) + 1 shared expert, 61 layers, d_model 7168,
expert d_ff 2048 [arXiv:2412.19437]. This is the model behind the paper's
Figs 1, 3–6, 8–14 (8×EP on MI325X/MI300X).

Fidelity note (DESIGN.md §3): DeepSeek-V3 uses MLA attention; ViBE is an
*expert-placement* technique and never touches attention, so we model
attention as GQA (kv=16, head_dim 128) — the MoE side (256 experts, top-8,
shared expert, sigmoid-free softmax gating) is exact, which is what the
placement experiments exercise.
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=16,
    d_ff=18432,              # first dense layers' FFN (moe_offset below)
    vocab=129280,
    head_dim=128,
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    moe_every=1,
    mlp_gated=True,
    source="arXiv:2412.19437 (paper's own model)",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="deepseek-v3-smoke",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    n_experts=16,
    top_k=4,
    moe_d_ff=64,
    n_shared_experts=1,
    vocab=512,
)
