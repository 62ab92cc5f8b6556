"""Masked-softmax attention over the GQA layout, in torch ops.

The counterparts of ``repro.models.flash`` (plain jnp there, not Pallas,
so not kernels to port). GQA layout: q (B, Sq, KV, G, hd), k/v
(B, Skv, KV, hd) with G = H / KV. Causal, sliding-window and ``kv_valid``
masks are data, as in the reference.

Both functions take one softmax over all keys. The reference's online
softmax walks the keys in chunks (1024 for prefill, 2048 for decode); with
one chunk it is this computation exactly, and past one chunk it differs by
rounding only. Cast points follow the reference: f32 scores, the
probabilities cast to ``v``'s dtype before the PV product, f32
accumulation, the output in ``q``'s dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention", "flash_decode"]

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def _scale(hd: int) -> float:
    # 1 / sqrt(hd) rounded as the reference rounds it: both steps in f32
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


def _window_ok(delta: torch.Tensor, window) -> torch.Tensor:
    """``delta < window`` where the window is positive; all True at 0."""
    w = torch.as_tensor(window, device=delta.device)
    return torch.where(w > 0, delta < w, torch.ones_like(delta, dtype=bool))


def flash_attention(
    q: torch.Tensor,                      # (B, Sq, KV, G, hd)
    k: torch.Tensor,                      # (B, Skv, KV, hd)
    v: torch.Tensor,                      # (B, Skv, KV, hd)
    *,
    causal: bool = True,
    window=None,                          # scalar; 0/None = full
    q_positions: Optional[torch.Tensor] = None,    # (Sq,)
    kv_positions: Optional[torch.Tensor] = None,   # (Skv,)
    kv_valid: Optional[torch.Tensor] = None,       # (Skv,) bool
) -> torch.Tensor:
    """Masked softmax attention. Returns (B, Sq, KV, G, hd) in q's dtype."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    if causal:
        mask = mask & (kv_positions[None, :] <= q_positions[:, None])
    if window is not None:
        mask = mask & _window_ok(q_positions[:, None] - kv_positions[None, :],
                                 window)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * _scale(hd)
    s = s.masked_fill(~mask, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype), v).float()
    out = (pv / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4)                 # (B, Sq, KV, G, hd)


def flash_decode(
    q: torch.Tensor,                      # (B, KV, G, hd) — one new token
    k_cache: torch.Tensor,                # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    pos: torch.Tensor,                    # (B,) per-sequence positions
    *,
    window=None,
    kpos_offset: int = 0,                 # global position of cache row 0
    return_stats: bool = False,           # (acc, m, l) for a cross-shard merge
):
    """Single-token decode against the cache; rows past ``pos`` (per
    sequence, continuous batching) are masked. Returns (B, KV, G, hd), or
    with ``return_stats`` the un-normalised softmax over this cache's rows:
    ``acc`` (B, KV, G, hd) f32 — sum of p·v, p cast to ``v``'s dtype —
    ``m`` (B, KV, G) f32 — the row max after masking — and ``l`` — sum of
    exp(s - m) over the valid rows. A cache (shard) with no valid row gives
    ``m = _NEG`` and ``l = 0``."""
    B, S_max, KV, hd = k_cache.shape
    pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device), (B,))
    kp = kpos_offset + torch.arange(S_max, device=q.device)
    valid = kp[None, :] <= pos[:, None]                       # (B, S_max)
    if window is not None:
        valid = valid & _window_ok(pos[:, None] - kp[None, :], window)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) \
        * _scale(hd)
    invalid = ~valid[:, None, None, :]
    s = s.masked_fill(invalid, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if return_stats:
        p = p.masked_fill(invalid, 0.0)
    l = p.sum(dim=-1)
    pv = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache).float()
    if return_stats:
        return pv, m[..., 0], l
    return (pv / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
