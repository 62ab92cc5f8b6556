"""codeqwen1.5-7b — qwen1.5-arch dense code LM (MHA: kv == heads).

[dense] 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    head_dim=128,
    mlp_gated=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="codeqwen1.5-7b-smoke",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=448,
    vocab=512,
)
