"""Shared model building blocks (PyTorch, params as dicts of tensors).

The counterparts of ``repro.models.common``: compute in the params' dtype
(bf16 on the serving path), normalisation and RoPE in f32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import collectives as C

__all__ = ["rms_norm", "rope_tables", "apply_rope", "dense_init", "matmul",
           "mlp", "softmax_xent_chunked"]


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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype the two promote to, as ``jnp.einsum``
    computes a product of mixed dtypes (torch's ``@`` refuses them): an
    f32 residual through bf16 weights (hubert's f32 features) computes
    and gives f32."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def mlp(p, x: torch.Tensor, gated: bool, group=None,
        seq: bool = False) -> torch.Tensor:
    """SwiGLU (gated) or GELU (2-matrix) MLP. With a tensor-parallel
    ``group`` the weights are the rank's slice of F: ``w1`` and ``w3``
    column-parallel, ``w2`` row-parallel, as the reference's TP-sharded
    hidden. The input is the rank's rows, replicated over the group
    (its gradient summed over the group) and the partials summed; with
    ``seq`` (sequence parallelism) the rank's rows of the sequence,
    gathered over the group before ``w1`` and the partials reduce-
    scattered back to them."""
    x = C.gather_seq(x, group) if seq else C.replicate(x, group)
    h = matmul(x, p["w1"])
    if gated:
        h = F.silu(h) * matmul(x, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu default
    out = matmul(h, p["w2"])
    return C.scatter_partials(out, group) if seq else C.sum_partials(out,
                                                                     group)


def softmax_xent_chunked(hidden: torch.Tensor, w_unemb: torch.Tensor,
                         labels: torch.Tensor, n_chunks: int = 8,
                         group=None, vocab_offset: int = 0,
                         denom=None) -> torch.Tensor:
    """Mean token cross-entropy without the whole (B, S, V) logits at once:
    the rows' sum divided by ``denom`` (None: ``B * S``, their count).

    The sequence axis is taken in ``n_chunks`` pieces (one if it does not
    divide S), so the logits live as (B, S / n_chunks, V) f32 a piece, as
    the reference's scan does. The unembedding product runs in the
    params' dtype and its result is cast to f32, the reference's rounding
    point.

    With a tensor-parallel ``group``, ``w_unemb`` is the rank's vocabulary
    slice (D, V/tp) starting at id ``vocab_offset`` (the reference's
    ``logits_spec``), and the loss is the vocab-parallel cross entropy:
    the row max over the ranks (detached: a shift), ``sum exp`` summed over
    the ranks, the gold logit from the rank that holds it. Each rank's
    gradient of ``hidden`` is then its vocabulary slice's share: the
    caller sums it over the group (``replicate``, or ``gather_seq``'s
    reduce-scatter).
    """
    B, S, D = hidden.shape
    if S % n_chunks != 0:
        n_chunks = 1
    rows = S // n_chunks
    total = None
    for i in range(n_chunks):
        hc = hidden[:, i * rows:(i + 1) * rows]
        yc = labels[:, i * rows:(i + 1) * rows].long()
        logits = matmul(hc, w_unemb).float()
        if group is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        else:
            logz, gold = _xent_terms(logits, yc, group, vocab_offset)
        part = torch.sum(logz - gold)
        total = part if total is None else total + part
    return total / (B * S if denom is None else denom)


def _xent_terms(logits: torch.Tensor, labels: torch.Tensor, group,
                vocab_offset: int):
    """(logsumexp, gold logit) of rows whose vocabulary is split over
    ``group``; ``logits`` (..., V/tp) f32 is this rank's slice."""
    n = logits.shape[-1]
    m = C.max_over(logits.detach().amax(dim=-1), group)
    total = C.sum_partials(torch.exp(logits - m[..., None]).sum(dim=-1),
                           group)
    local = labels - vocab_offset
    mine = (local >= 0) & (local < n)
    g = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = C.sum_partials(torch.where(mine, g, torch.zeros_like(g)), group)
    return m + torch.log(total), gold
