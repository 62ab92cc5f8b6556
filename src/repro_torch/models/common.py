"""Shared model building blocks (PyTorch, params as dicts of tensors).

The counterparts of ``repro.models.common``: compute in the params' dtype
(bf16 on the serving path), normalisation and RoPE in f32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope_tables", "apply_rope", "dense_init", "mlp",
           "softmax_xent_chunked"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """f32 RMS norm scaled by ``(1 + scale)``, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """cos/sin tables for the given positions → ((..., hd/2), (..., hd/2))."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE. x: (..., S, H, hd); cos/sin: (..., S, hd/2)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, device=None,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/d_in) weight (lead..., d_in, d_out) drawn in f32 with
    ``generator``, which must live on ``device``."""
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=generator,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def mlp(p, x: torch.Tensor, gated: bool) -> torch.Tensor:
    """SwiGLU (gated) or GELU (2-matrix) MLP."""
    h = x @ p["w1"]
    if gated:
        h = F.silu(h) * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu default
    return h @ p["w2"]


def softmax_xent_chunked(hidden: torch.Tensor, w_unemb: torch.Tensor,
                         labels: torch.Tensor,
                         n_chunks: int = 8) -> torch.Tensor:
    """Mean token cross-entropy without the whole (B, S, V) logits at once.

    The sequence axis is taken in ``n_chunks`` pieces (one if it does not
    divide S), so the logits live as (B, S / n_chunks, V) f32 a piece, as
    the reference's scan does. The unembedding product runs in the
    params' dtype and its result is cast to f32, the reference's rounding
    point.
    """
    B, S, D = hidden.shape
    if S % n_chunks != 0:
        n_chunks = 1
    C = S // n_chunks
    total = None
    for i in range(n_chunks):
        hc = hidden[:, i * C:(i + 1) * C]
        yc = labels[:, i * C:(i + 1) * C].long()
        logits = (hc @ w_unemb).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        part = torch.sum(logz - gold)
        total = part if total is None else total + part
    return total / (B * S)
