"""xlstm-350m — sLSTM + mLSTM recurrent LM.

[ssm] 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]

Block pattern per the xLSTM paper's 7:1 ratio: 1 sLSTM block per 8, rest
mLSTM (matrix-memory). d_ff=0: blocks carry their own up/down projections
(expand factor 2) instead of a separate FFN.
"""

import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=256,
    slstm_every=8,           # 1 sLSTM per 8 blocks, rest mLSTM
    ssm_expand=2,
    mlp_gated=True,
    source="arXiv:2405.04517; unverified",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="xlstm-350m-smoke",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    vocab=512,
    slstm_every=2,
)
