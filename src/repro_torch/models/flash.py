"""Chunked (flash-style) attention over the GQA layout, in torch ops.

The counterparts of ``repro.models.flash`` (plain jnp there, not Pallas):
the reference's online softmax, which walks query chunks of ``q_chunk``
(512) and key chunks of ``kv_chunk`` (1024) at prefill, and the cache in
chunks of 2048 rows (halved until they divide ``S_max``) at decode, so
that no more than one chunk pair's (B, KV, G, Cq, Ck) scores is live:
O(Cq·Ck) a (batch, head), never O(S²). When an input requires a gradient
each key chunk runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so the backward recomputes a chunk pair's scores and
keeps no S×S residual. GQA layout: q (B, Sq, KV, G, hd), k/v
(B, Skv, KV, hd) with G = H / KV. Causal, sliding-window and ``kv_valid``
masks are data on position arrays, as in the reference.

Cast points follow the reference: f32 scores, the running max, sum and
accumulator in f32, the probabilities cast to ``v``'s dtype before the PV
product, the output in ``q``'s dtype. The reference's two environment
knobs (``REPRO_FLASH_BF16``, ``REPRO_FLASH_KV_CHUNK``) are not ported;
their defaults are.

These are the plain versions: a CPU tensor runs them; on the card
:mod:`repro_torch.kernels.ops` sends every call to the hand-written
kernels of ``kernels/csrc/flash_attention.cu``
(:mod:`repro_torch.kernels.flash`). :func:`flash_attention_bwd` is the
backward of a prefill call from its output and rows' softmax stats: it
recomputes each chunk pair's scores, as the checkpoint does. It is the
plain version of the backward's kernels (``kernels/csrc/
flash_attention_bwd.cu``), which take its place on the card; the CPU and
the tests run it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["flash_attention", "flash_attention_bwd", "flash_decode",
           "padded_keys"]

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


@functools.lru_cache(maxsize=None)
def _scale(hd: int) -> float:
    # 1 / sqrt(hd) rounded as the reference rounds it: both steps in f32
    # (numpy's, so that no tensor operation runs)
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _window_ok(delta: torch.Tensor, window) -> torch.Tensor:
    """``delta < window`` where the window is positive; all True at 0."""
    if not isinstance(window, torch.Tensor):
        if window > 0:
            return delta < window
        return torch.ones_like(delta, dtype=torch.bool)
    w = window.to(delta.device)
    return torch.where(w > 0, delta < w, torch.ones_like(delta, dtype=bool))


def padded_keys(Skv: int, kv_chunk: int = 1024) -> int:
    """The key count ``flash_attention`` walks: ``Skv`` padded to a
    multiple of ``min(kv_chunk, Skv)``. A query row with no valid key gives
    the sum of ``v`` over the keys divided by this (every key, padding
    included, takes ``exp(_NEG - _NEG) = 1``; padding's ``v`` is zero)."""
    c = min(kv_chunk, Skv)
    return Skv + (-Skv) % c


def _pair_mask(qpos, kpos, kval, causal, window):
    """(Cq, Ck): which (query, key) pairs of a chunk pair take part."""
    mask = kval[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & _window_ok(qpos[:, None] - kpos[None, :], window)
    return mask


def _kv_step(m, l, acc, qi, kj, vj, qpos, kpos, kval, *, causal, window,
             scale):
    """One key chunk of the online softmax for one query chunk."""
    s = torch.einsum("bqkgh,bskh->bkgqs", qi.float(), kj.float()) * scale
    mask = _pair_mask(qpos, kpos, kval, causal, window)
    s = s.masked_fill(~mask, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vj.dtype), vj).float()
    return m_new, l_new, acc * corr[..., None] + pv


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
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    return_stats: bool = False,
):
    """Online-softmax attention, O(Cq·Ck) live scores. Returns
    (B, Sq, KV, G, hd) in q's dtype, or with ``return_stats`` ``(out, m,
    l)``: each row's running max and sum over the keys, f32 (B, KV, G,
    Sq) (a row with no valid key: ``m = _NEG``, ``l`` the padded key
    count, :func:`padded_keys`). q is padded to a chunk multiple with its
    last position (the padded rows dropped), k/v with zeros masked through
    ``kv_valid``, as the reference pads them."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    pq, pk = (-Sq) % q_chunk, (-Skv) % kv_chunk
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    if kv_valid is None:
        kv_valid = torch.ones((Skv,), dtype=torch.bool, device=dev)
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_positions = torch.cat([q_positions, q_positions[-1:].expand(pq)])
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        kv_positions = torch.cat([kv_positions,
                                  kv_positions.new_zeros(pk)])
        kv_valid = torch.cat([kv_valid, kv_valid.new_zeros(pk)])
    step = functools.partial(_kv_step, causal=causal, window=window,
                             scale=_scale(hd))
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    outs, ms, ls = [], [], []
    for i in range(0, Sq + pq, q_chunk):
        qi, qpos = q[:, i:i + q_chunk], q_positions[i:i + q_chunk]
        m = torch.full((B, KV, G, q_chunk), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for j in range(0, Skv + pk, kv_chunk):
            cut = slice(j, j + kv_chunk)
            args = (m, l, acc, qi, k[:, cut], v[:, cut], qpos,
                    kv_positions[cut], kv_valid[cut])
            if grad:
                m, l, acc = checkpoint(step, *args, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                m, l, acc = step(*args)
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, 3).permute(0, 3, 1, 2, 4)  # (B, Sq+pq, KV, G, hd)
    out = out[:, :Sq] if pq else out
    if return_stats:
        return out, torch.cat(ms, -1)[..., :Sq], torch.cat(ls, -1)[..., :Sq]
    return out


@torch.no_grad()
def flash_attention_bwd(
    q: torch.Tensor,                      # (B, Sq, KV, G, hd)
    k: torch.Tensor,                      # (B, Skv, KV, hd)
    v: torch.Tensor,                      # (B, Skv, KV, hd)
    out: torch.Tensor,                    # (B, Sq, KV, G, hd), the forward's
    dout: torch.Tensor,                   # (B, Sq, KV, G, hd)
    m: torch.Tensor,                      # (B, KV, G, Sq) f32, the forward's
    l: torch.Tensor,                      # (B, KV, G, Sq) f32, the forward's
    *,
    causal: bool = True,
    window=None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` from its
    output and its rows' stats, chunk pair by chunk pair (O(Cq·Ck) live
    scores, as the forward): a pair's scores again, ``p = exp(s - m) /
    l``, then ``dv += pᵀ·dout``, ``dp = dout·vᵀ``, ``ds = p (dp - D)`` on
    the pairs the masks keep (``D`` = dout·out a row), ``dq += ds·k``,
    ``dk += dsᵀ·q`` (both times the scale). All in f32, each gradient in
    its input's dtype. A row with no valid key passes ``dout / l`` to
    every key's ``v`` and nothing to q or k, as autograd of the forward
    does."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    if kv_valid is None:
        kv_valid = torch.ones((Skv,), dtype=torch.bool, device=dev)
    scale = _scale(hd)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    for i in range(0, Sq, q_chunk):
        rows = slice(i, i + q_chunk)
        qi, doi = q[:, rows].float(), dout[:, rows].float()
        di = (doi * out[:, rows].float()).sum(-1).permute(0, 2, 3, 1)
        mi, li = m[..., rows, None], l[..., rows, None]
        for j in range(0, Skv, kv_chunk):
            cut = slice(j, j + kv_chunk)
            kj, vj = k[:, cut].float(), v[:, cut].float()
            mask = _pair_mask(q_positions[rows], kv_positions[cut],
                              kv_valid[cut], causal, window)
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj) * scale
            p = torch.exp(s.masked_fill_(~mask, _NEG) - mi) / li
            dv[:, cut] += torch.einsum("bkgqs,bqkgh->bskh", p, doi)
            ds = torch.einsum("bqkgh,bskh->bkgqs", doi, vj)
            ds = (p * (ds - di[..., None])).masked_fill_(~mask, 0.0) * scale
            dq[:, rows] += torch.einsum("bkgqs,bskh->bqkgh", ds, kj)
            dk[:, cut] += torch.einsum("bkgqs,bqkgh->bskh", ds, qi)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_decode(
    q: torch.Tensor,                      # (B, KV, G, hd) — one new token
    k_cache: torch.Tensor,                # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    pos: torch.Tensor,                    # (B,) per-sequence positions
    *,
    window=None,
    kv_chunk: int = 2048,
    kpos_offset: int = 0,                 # global position of cache row 0
    return_stats: bool = False,           # (acc, m, l) for a cross-shard merge
):
    """Single-token decode against the cache, walked in chunks of
    ``kv_chunk`` rows (halved until they divide ``S_max``; each a slice of
    the cache in place, cast one chunk at a time); rows past ``pos`` (per
    sequence, continuous batching) are masked. Returns (B, KV, G, hd), or
    with ``return_stats`` the un-normalised softmax over this cache's rows:
    ``acc`` (B, KV, G, hd) f32 — sum of p·v, p cast to ``v``'s dtype —
    ``m`` (B, KV, G) f32 — the row max after masking — and ``l`` — sum of
    exp(s - m) over the valid rows. A cache (shard) with no valid row gives
    ``m = _NEG``, ``l = 0`` and ``acc = 0`` (masked rows take p = 0 there,
    where the reference's take 1: :func:`~.model._merge_decode` relies on
    it)."""
    B, S_max, KV, hd = k_cache.shape
    G = q.shape[2]
    dev = q.device
    pos = torch.broadcast_to(torch.as_tensor(pos, device=dev), (B,))
    kv_chunk = min(kv_chunk, S_max)
    while S_max % kv_chunk:            # keep the cache unpadded, uncopied
        kv_chunk //= 2
    scale = _scale(hd)
    m = torch.full((B, KV, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=dev)
    qf = q.float()
    for start in range(0, S_max, kv_chunk):
        kj = k_cache[:, start:start + kv_chunk]
        vj = v_cache[:, start:start + kv_chunk]
        kp = kpos_offset + start + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bkgh,bskh->bkgs", qf, kj.float()) * scale
        valid = kp[None, :] <= pos[:, None]                   # (B, Ck)
        if window is not None:
            valid = valid & _window_ok(pos[:, None] - kp[None, :], window)
        invalid = ~valid[:, None, None, :]
        s = s.masked_fill(invalid, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if return_stats:
            p = p.masked_fill(invalid, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgs,bskh->bkgh", p.to(vj.dtype), vj).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    if return_stats:
        return acc, m, l
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
