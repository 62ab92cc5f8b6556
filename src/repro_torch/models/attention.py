"""GQA attention parameters (the computation is in :mod:`.flash` and the
model's block body)."""

from __future__ import annotations

from typing import Tuple

import torch

from .common import dense_init

__all__ = ["attn_init"]


def attn_init(generator: torch.Generator, d: int, n_heads: int, n_kv: int,
              hd: int, dtype=torch.bfloat16, device=None,
              lead: Tuple[int, ...] = ()):
    return {
        "wq": dense_init(generator, d, n_heads * hd, dtype, device, lead),
        "wk": dense_init(generator, d, n_kv * hd, dtype, device, lead),
        "wv": dense_init(generator, d, n_kv * hd, dtype, device, lead),
        "wo": dense_init(generator, n_heads * hd, d, dtype, device, lead),
    }
