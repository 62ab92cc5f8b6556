"""Plain PyTorch versions of the kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each hand-written
kernel against them on the card. They repeat the kernels' arithmetic
(f32 accumulation, the hidden activation rounded to the input dtype before
the down projection) and are no yardstick of speed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["moe_ffn_ref", "ragged_moe_ffn_ref", "router_topk_ref",
           "route_select_ref", "assignment_uniforms", "select_slots",
           "masked_tally", "aux_loss"]


def _swiglu_ffn(x, w1, w3, w2):
    """Batched SwiGLU FFN: x (N, R, D), w1/w3 (N, D, F), w2 (N, F, D).

    f32 products; ``h`` rounded to the input dtype before the down
    projection, as the Pallas kernels do.
    """
    xf = x.float()
    h = torch.bmm(xf, w1.float())
    g = torch.bmm(xf, w3.float())
    h = (F.silu(h) * g).to(x.dtype)
    return torch.bmm(h.float(), w2.float())


def moe_ffn_ref(w1, w3, w2, toks):
    """Grouped SwiGLU expert FFN. toks (E, C, D) → (E, C, D)."""
    return _swiglu_ffn(toks, w1, w3, w2).to(toks.dtype)


def ragged_moe_ffn_ref(w1, w3, w2, toks, tile_group, row_offsets=None,
                       sizes=None, max_rows=None):
    """Ragged grouped SwiGLU FFN. toks (T, D) → (T, D).

    ``toks`` is the group-sorted flat buffer (each expert's segment padded
    to a multiple of the row tile ``bm = T // len(tile_group)``);
    ``tile_group`` holds the owning expert per (bm, D) tile, sentinel ``E``
    for unoccupied tiles, whose rows come out exactly zero.
    ``row_offsets``, ``sizes`` and ``max_rows`` are the kernel's hints and
    are ignored: padding rows are zero, and SwiGLU(0) = 0.
    """
    T, D = toks.shape
    n_tiles = tile_group.shape[0]
    E = w1.shape[0]
    g = torch.clamp(tile_group.long(), max=E - 1)
    x = toks.reshape(n_tiles, T // n_tiles, D)
    y = _swiglu_ffn(x, w1[g], w3[g], w2[g])
    y = y * (tile_group < E).to(y.dtype)[:, None, None]
    return y.reshape(T, D).to(toks.dtype)


def _top_k_sweeps(p, top_k: int):
    """K masked argmax sweeps over probabilities ``p`` (T, E), then the
    selected weights divided by their sum clamped at 1e-9."""
    ws, ids = [], []
    for _ in range(top_k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        ws.append(torch.gather(p, -1, i))
        ids.append(i)
        p = p.scatter(-1, i, -1.0)
    w = torch.cat(ws, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, torch.cat(ids, dim=-1).to(torch.int32)


def router_topk_ref(logits, top_k: int):
    """Softmax → top-k → renormalize. logits (T, E) → ((T,K) f32, (T,K) i32).

    Top-k is K masked argmax sweeps, as the Pallas kernel does it:
    ``torch.argmax`` returns the first maximal index (the tie rule of
    ``lax.top_k``), while ``torch.topk``'s tie order is unspecified.
    """
    return _top_k_sweeps(torch.softmax(logits.float(), dim=-1), top_k)


_U32 = 0xFFFFFFFF
#: Knuth multiplicative-hash constant (the reference's ``_HASH_MULT``).
_HASH_MULT = 2654435761
#: odd stride of the per-step salt (the reference's ``_SEED_MULT``).
_SEED_MULT = 2246822519


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32): the product is
    split at 16 bits so no partial product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def assignment_uniforms(t: int, K: int, seed=None,
                        device=None) -> torch.Tensor:
    """Deterministic per-assignment uniforms u ∈ [0, 1) → (t, K) f32.

    The reference's uint32 wrap-around hash, bit for bit, computed in int64
    masked to 32 bits: top 24 bits of ``(i + seed·SEED_MULT)·HASH_MULT``.
    """
    i = torch.arange(t * K, dtype=torch.int64, device=device)
    if seed is not None:
        s = torch.as_tensor(seed, device=device).to(torch.int64) & _U32
        i = (i + _mul_u32(s, _SEED_MULT)) & _U32
    h = _mul_u32(i, _HASH_MULT)
    u = (h >> 8).to(torch.float32) * (2.0 ** -24)
    return u.reshape(t, K)


def select_slots(idx: torch.Tensor, slots_of: torch.Tensor,
                 n_copies: torch.Tensor,
                 copy_cdf: Optional[torch.Tensor] = None,
                 route_seed=None) -> torch.Tensor:
    """Map logical ids (t, K) to physical slots across replicas: by inverse
    CDF over ``copy_cdf`` (E, r_max), or the uniform ``% n_copies`` hash
    without it (see the reference's ``_select_slots``)."""
    t, K = idx.shape
    r_max = slots_of.shape[-1]
    ii = idx.long()
    if r_max == 1:
        return slots_of[:, 0][ii]
    if copy_cdf is None:
        copy = (torch.arange(t * K, dtype=torch.int64, device=idx.device)
                .reshape(t, K)) % n_copies[ii]
    else:
        u = assignment_uniforms(t, K, route_seed, device=idx.device)
        # smallest r with u < cdf[r]; the min() guards f32 round-up
        copy = (u[:, :, None] >= copy_cdf[ii]).sum(dim=-1)
        copy = torch.minimum(copy, (n_copies[ii] - 1).long())
    return slots_of[ii, copy.long()]


def masked_tally(idx, n_experts, row_valid=None):
    """Assignments per logical expert (E,) f32, rows ``row_valid`` masks
    out not counted."""
    oh = (idx[..., None] == torch.arange(n_experts, device=idx.device)
          ).to(torch.float32)
    if row_valid is not None:
        oh = oh * row_valid[:, None, None].to(torch.float32)
    return oh.sum(dim=(0, 1))


def aux_loss(tally, mean_prob, n_experts):
    """Load-balance aux loss ``E · dot(tally / max(Σ tally, 1), mean_prob)``."""
    frac = tally / torch.clamp(tally.sum(), min=1.0)
    return n_experts * torch.dot(frac, mean_prob)


def route_select_ref(x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                     top_k: int, row_valid=None):
    """A layer's routing stage, the reference's ``route`` →
    ``_select_slots`` → ``_masked_tally`` → ``_aux_loss``: x (T, D) and the
    f32 router (D, E) → ``(weights (T, K) f32, idx (T, K) int32, slots
    (T, K) int32, tally (E + 1,) f32, mean_prob (E,) f32, aux () f32)``.

    The product is taken in f32; weights are zero on rows ``row_valid``
    masks, which the tally does not count, while ``mean_prob`` averages all
    T rows, as the reference's. ``tally[E]`` is 0 (the capacity paths write
    their drops there).
    """
    E = router_w.shape[1]
    p = torch.softmax(x.float() @ router_w, dim=-1)
    weights, idx = _top_k_sweeps(p, top_k)
    mean_prob = p.mean(dim=0)
    if row_valid is not None:
        weights = weights * row_valid[:, None].to(weights.dtype)
    slots = select_slots(idx, slots_of, n_copies, copy_cdf, route_seed)
    tally = masked_tally(idx, E, row_valid)
    aux = aux_loss(tally, mean_prob, E)
    tally = torch.cat([tally, tally.new_zeros((1,))])
    return weights, idx, slots.to(torch.int32), tally, mean_prob, aux
