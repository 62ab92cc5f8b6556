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

__all__ = ["moe_ffn_ref", "moe_ffn_bwd_ref", "ragged_moe_ffn_ref",
           "ragged_moe_ffn_bwd_ref",
           "router_topk_ref", "route_select_ref", "route_select_dlogits_ref",
           "route_select_bwd_ref", "router_product_bwd",
           "assignment_uniforms", "select_slots",
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


def _swiglu_bwd(x, W1, W3, W2, dy, dt):
    """The SwiGLU FFN's backward over a batch of row groups, f32 in and
    out: x, dy (N, R, D), W1/W3 (N, D, F), W2 (N, F, D) →
    ``(dx, dW1, dW3, dW2)`` of each group, with the kernels' rounding to
    ``dt``: ``h``, ``da`` and ``db`` rounded before they are used."""
    a = torch.bmm(x, W1)
    b = torch.bmm(x, W3)
    s = torch.sigmoid(a)
    silu = a * s
    h = (silu * b).to(dt).float()
    dh = torch.bmm(dy, W2.transpose(1, 2))
    da = (dh * b * s * (1.0 + a * (1.0 - s))).to(dt).float()
    db = (dh * silu).to(dt).float()
    dx = torch.bmm(da, W1.transpose(1, 2)) + torch.bmm(db, W3.transpose(1, 2))
    xt = x.transpose(1, 2)
    return (dx, torch.bmm(xt, da), torch.bmm(xt, db),
            torch.bmm(h.transpose(1, 2), dy))


def ragged_moe_ffn_bwd_ref(w1, w3, w2, toks, tile_group, dy):
    """Backward of :func:`ragged_moe_ffn_ref`: ``dy (T, D)`` →
    ``(dtoks (T, D), dw1, dw3 (E, D, F), dw2 (E, F, D))``, each in its
    input's dtype.

    The forward's rounding points: f32 products, ``a = x W1`` and
    ``b = x W3`` recomputed in f32, ``h = silu(a) b`` rounded to the input
    dtype for ``dw2 = hᵀ dy``. ``dh = dy W2ᵀ`` in f32, then
    ``da = dh b σ(a)(1 + a(1 − σ(a)))`` and ``db = dh silu(a)`` rounded to
    the input dtype (the CUDA kernels pass them on in bf16), from which
    ``dx = da W1ᵀ + db W3ᵀ``, ``dw1 = xᵀ da`` and ``dw3 = xᵀ db`` sum in
    f32. Sentinel tiles get no gradient; an expert with no tile gets zero.
    """
    T, D = toks.shape
    n_tiles = tile_group.shape[0]
    E = w1.shape[0]
    dt = toks.dtype
    g = torch.clamp(tile_group.long(), max=E - 1)
    occ = (tile_group < E).to(torch.float32)[:, None, None]
    x = toks.reshape(n_tiles, T // n_tiles, D).float()
    dyv = dy.reshape(n_tiles, T // n_tiles, D).float() * occ
    dx, *tiles = _swiglu_bwd(x, w1[g].float(), w3[g].float(), w2[g].float(),
                             dyv, dt)

    def per_expert(t):
        out = t.new_zeros((E,) + tuple(t.shape[1:]))
        return out.index_add_(0, g, t * occ)

    dw1, dw3, dw2 = (per_expert(t) for t in tiles)
    return (dx.reshape(T, D).to(dt), dw1.to(w1.dtype), dw3.to(w3.dtype),
            dw2.to(w2.dtype))


def moe_ffn_bwd_ref(w1, w3, w2, toks, dy):
    """Backward of :func:`moe_ffn_ref` over capacity buckets: ``dy (E, C,
    D)`` → ``(dtoks (E, C, D), dw1, dw3 (E, D, F), dw2 (E, F, D))``, each
    in its input's dtype, at the rounding points of the bucket kernels
    (``csrc/moe_ffn_bwd.cu``) and :func:`ragged_moe_ffn_bwd_ref`: ``h``,
    ``da`` and ``db`` rounded to the input dtype, every sum in f32. Every
    bucket row counts; an empty row (x = 0, dy = 0) gives exact zeros."""
    dx, dw1, dw3, dw2 = _swiglu_bwd(toks.float(), w1.float(), w3.float(),
                                    w2.float(), dy.float(), toks.dtype)
    return (dx.to(toks.dtype), dw1.to(w1.dtype), dw3.to(w3.dtype),
            dw2.to(w2.dtype))


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
                     top_k: int, row_valid=None, with_probs: bool = False):
    """A layer's routing stage, the reference's ``route`` →
    ``_select_slots`` → ``_masked_tally`` → ``_aux_loss``: x (T, D) and the
    f32 router (D, E) → ``(weights (T, K) f32, idx (T, K) int32, slots
    (T, K) int32, tally (E + 1,) f32, mean_prob (E,) f32, aux () f32)``.

    The product is taken in f32; weights are zero on rows ``row_valid``
    masks, which the tally does not count, while ``mean_prob`` averages all
    T rows, as the reference's. ``tally[E]`` is 0 (the capacity paths write
    their drops there). ``with_probs`` also returns the softmax ``p``
    (T, E), seventh, as the training forward keeps it.
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
    out = (weights, idx, slots.to(torch.int32), tally, mean_prob, aux)
    return out + (p,) if with_probs else out


def route_select_dlogits_ref(probs, idx, weights, tally, dweights,
                             dmean_prob, daux, row_valid=None):
    """Backward of the routing stage to its logits: ``(T, E)`` f32.

    ``probs`` (T, E) the softmax, ``idx``/``weights`` (T, K) the forward's
    top-k and gate weights (zero on rows ``row_valid`` masks), ``tally``
    (≥ E,) its counts, and the gradients of the weights (T, K), of
    ``mean_prob`` (E,) and of ``aux`` (). The tally is held constant
    (integer counts have no gradient), so with ``frac = tally /
    max(Σ tally, 1)``: ``dmean = E frac daux + dmean_prob``; on a valid
    row ``dp[idx_k] = (dw_k − Σ_j dw_j w_j) / Σ_j p[idx_j]`` (the
    renormalisation's gradient); every row adds ``dmean / T`` (the mean
    runs over all T rows); and ``dlogits = p ⊙ (dp − Σ p dp)``.
    """
    T, E = probs.shape
    cnt = tally[:E]
    frac = cnt / torch.clamp(cnt.sum(), min=1.0)
    dmean = E * frac * daux + dmean_prob
    ii = idx.long()
    s = torch.gather(probs, 1, ii).sum(-1, keepdim=True)
    inner = (dweights * weights).sum(-1, keepdim=True)
    dpk = (dweights - inner) / s
    if row_valid is not None:
        dpk = dpk * row_valid[:, None].to(dpk.dtype)
    dp = torch.zeros_like(probs).scatter(1, ii, dpk) + dmean / T
    return probs * (dp - (probs * dp).sum(-1, keepdim=True))


def route_select_bwd_ref(x, router_w, probs, idx, weights, tally, dweights,
                         dmean_prob, daux, row_valid=None):
    """Backward of :func:`route_select_ref` to its differentiable inputs:
    ``(dx (T, D) in x's dtype, drouter (D, E) f32)``, through
    :func:`route_select_dlogits_ref` and the f32 router product."""
    dl = route_select_dlogits_ref(probs, idx, weights, tally, dweights,
                                  dmean_prob, daux, row_valid)
    return router_product_bwd(x, router_w, dl)


def router_product_bwd(x, router_w, dlogits):
    """The f32 router product's backward: ``dx = dlogits Wᵀ`` in x's
    dtype and ``dW = f32(x)ᵀ dlogits``. Plain matrix products on both
    devices, as the reference leaves its router product to XLA."""
    return ((dlogits @ router_w.T).to(x.dtype),
            x.float().T @ dlogits)
