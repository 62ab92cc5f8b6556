"""Recurrent sequence mixers: Mamba (S6) for jamba, mLSTM and sLSTM for
xLSTM.

The counterpart of ``repro.models.ssm``, with its names and its rounding
points: states and gate sums in f32, activations in the params' dtype,
``r_gates`` in the params' dtype with ``h`` cast to it before the
recurrent product. Sequences run chunk by chunk; decode is the one-token
case of the same code (``*_step`` is ``*_seq`` with a chunk of one).

The chunk width follows the reference: ``W = min(chunk, S)``, halved
until it divides S, so a prime S runs one token a chunk. It sets where
the f32 sums round, and so the parity with the reference.

Departures, each within the tests' tolerances:

* ``mamba_seq`` scans inside a chunk with a log-depth (Hillis-Steele)
  scan of torch ops in place of ``lax.associative_scan``: the f32 sums
  come in another order.
* ``slstm_seq`` computes the input gates of the whole sequence in one
  product before the recurrence, where the reference computes them a
  token at a time; ``_slstm_cell`` takes that token's row.
* Nothing is checkpointed: the reference's ``jax.checkpoint`` on each
  chunk body saves memory under autograd only, and the full-width xLSTM
  step does not need it.
* ``mamba_seq`` takes ``u @ x_proj`` for the whole sequence in one
  product before the chunks, where the reference takes it a chunk at a
  time: the product is per token, so only the products' shapes differ.

Tensor parallelism (``group``, ``seq``; as ``common.mlp`` takes them):
with a tensor-parallel ``group`` the params and the state are the rank's
slice (``launch.sharding``'s cuts, :data:`~.sharding.MIXER_TP_CUT`) —
Mamba's ``di/tp`` channels, mLSTM's and sLSTM's ``H/tp`` heads. The input
is the rank's rows replicated over the group (its gradient summed), or
with ``seq`` (sequence parallelism) the rank's positions gathered over
it; the output is the rank's partial of the row-parallel out-projection,
summed over the group or reduce-scattered back to the rank's positions.
Inside, Mamba sums ``u @ x_proj``'s (B, S, dt_rank + 2 ds) partials over
the group in f32 and rounds them once, where one device rounds the whole
product; mLSTM sums its norm's sums of squares over the group (the norm
is over the whole ``di``); sLSTM needs no exchange. A whole leaf that a
rank reads in part (Mamba's ``dt_bias`` and ``D_skip``, mLSTM's u half of
``up``, sLSTM's ``up``) gets its gradient summed over the group by the
caller (``model._sum_over_rows``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives as C
from .common import dense_init, rms_norm

__all__ = [
    "mamba_init", "mamba_seq", "mamba_step", "mamba_state_init",
    "mlstm_init", "mlstm_seq", "mlstm_step", "mlstm_state_init",
    "slstm_init", "slstm_seq", "slstm_step", "slstm_state_init",
]


def _chunk_width(S: int, chunk: int) -> int:
    W = min(chunk, S)
    while S % W:
        W //= 2
    return W


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)``, the reference's log sigmoid."""
    return -F.softplus(-x)


def _enter(x: torch.Tensor, group, seq: bool) -> torch.Tensor:
    """A mixer's input on a tensor-parallel ``group``: the rank's rows
    replicated, or under ``seq`` its positions gathered."""
    return C.gather_seq(x, group) if seq else C.replicate(x, group)


def _leave(out: torch.Tensor, group, seq: bool) -> torch.Tensor:
    """A row-parallel product's partial: summed over ``group``, or under
    ``seq`` reduce-scattered to the rank's positions."""
    return (C.scatter_partials(out, group) if seq
            else C.sum_partials(out, group))


def _summed(part: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partials summed over ``group``, each rank reading the sum
    for its own share: forward one sum, backward the sum of the ranks'
    gradients (``replicate``)."""
    return C.replicate(C.sum_partials(part, group), group)


def _rank(group) -> int:
    return 0 if group is None else torch.distributed.get_rank(group)


# ---------------------------------------------------------------------------
# Mamba (S6) — selective state space, as used by Jamba
# ---------------------------------------------------------------------------

def mamba_init(generator: torch.Generator, d: int, *, expand: int = 2,
               d_state: int = 16, d_conv: int = 4, dtype=torch.bfloat16,
               device=None, lead: Tuple[int, ...] = ()):
    """The reference's Mamba params (its shapes, dtypes and distributions),
    each with the leading ``lead`` axes, drawn with ``generator``."""
    di = expand * d
    dt_rank = max(16, d // 16)
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    conv = torch.randn(lead + (d_conv, di), generator=generator, **f32)
    dt = torch.rand(lead + (di,), generator=generator, **f32) * (0.1 - 1e-3) \
        + 1e-3
    a = torch.arange(1, d_state + 1, **f32)
    return {
        "in_proj": dense_init(generator, d, 2 * di, dtype, device, lead),
        "conv_w": (conv / math.sqrt(d_conv)).to(dtype),
        "x_proj": dense_init(generator, di, dt_rank + 2 * d_state, dtype,
                             device, lead),
        "dt_proj": dense_init(generator, dt_rank, di, torch.float32, device,
                              lead),
        "dt_bias": torch.log(torch.expm1(dt.clamp(min=1e-4))),
        "A_log": torch.log(a).expand(lead + (di, d_state)).contiguous(),
        "D_skip": torch.ones(lead + (di,), **f32),
        "out_proj": dense_init(generator, di, d, dtype, device, lead),
    }


def mamba_state_init(batch: int, d: int, *, expand: int = 2,
                     d_state: int = 16, d_conv: int = 4,
                     dtype=torch.bfloat16, device=None):
    di = expand * d
    return {"h": torch.zeros((batch, di, d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, d_conv - 1, di), dtype=dtype,
                                device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence. x (B, S, di), w (k, di).

    ``state`` — the previous (B, k-1, di) tail for decode continuation.
    Returns (y, new_state)."""
    B, S, di = x.shape
    k = w.shape[0]
    pad = (torch.zeros((B, k - 1, di), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                        # (B, S+k-1, di)
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(k))
    tail = (xp[:, S:, :] if k > 1
            else torch.zeros((B, 0, di), dtype=x.dtype, device=x.device))
    return y, tail


def _ssm_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1, from
    h_{-1} = 0: returns (prod a_1..a_t, h_t). Log-depth: step ``d``
    combines each element with the one ``d`` before it, with the
    reference's ``_ssm_comb``."""
    W = a.shape[1]
    d = 1
    while d < W:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def _x_proj(u: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``u @ x_proj`` (B, S, dt_rank + 2 ds) in f32, rounded to ``u``'s
    dtype once as one device's product rounds; on a ``group`` the ranks'
    f32 partials (their channels' rows) summed before that rounding."""
    if group is None:
        return (u @ w).float()
    return _summed(u.float() @ w.float(), group).to(u.dtype).float()


def mamba_seq(p, x: torch.Tensor, state=None, chunk: int = 128,
              group=None, seq: bool = False):
    """Full-sequence Mamba mixer. Returns (y (B, S, D), new_state). On a
    tensor-parallel ``group`` the params and state are the rank's
    channels (see the module's docstring)."""
    x = _enter(x, group, seq)
    B, S, D = x.shape
    u, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    di = u.shape[-1]
    r = _rank(group)
    own = slice(r * di, (r + 1) * di)       # its dt_bias, D_skip channels
    ds = p["A_log"].shape[1]
    u, conv_tail = _causal_conv(u, p["conv_w"],
                                None if state is None else state["conv"])
    u = F.silu(u)
    A = -torch.exp(p["A_log"])                              # (di, ds)
    dt_rank = p["dt_proj"].shape[0]
    proj = _x_proj(u, p["x_proj"], group)
    W = _chunk_width(S, chunk)
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
         if state is None else state["h"])
    ys = []
    for c in range(S // W):
        sl = slice(c * W, (c + 1) * W)
        uf = u[:, sl].float()
        dt_in, Bm, Cm = proj[:, sl].split([dt_rank, ds, ds], dim=-1)
        dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"][own])
        a = torch.exp(dt[..., None] * A)                    # (B, W, di, ds)
        bx = dt[..., None] * Bm[:, :, None, :] * uf[..., None]
        aa, bb = _ssm_scan(a, bx)
        h_all = aa * h[:, None] + bb
        y_w = (h_all * Cm[:, :, None, :]).sum(-1) + p["D_skip"][own] * uf
        h = h_all[:, -1]
        ys.append(y_w.to(x.dtype))
    y = torch.cat(ys, dim=1) * F.silu(z)
    return _leave(y @ p["out_proj"], group, seq), {"h": h,
                                                   "conv": conv_tail}


def mamba_step(p, x: torch.Tensor, state, group=None):
    """Single-token decode. x (B, 1, D) → (y (B, 1, D), new_state)."""
    return mamba_seq(p, x, state, chunk=1, group=group)


# ---------------------------------------------------------------------------
# mLSTM — matrix-memory LSTM (xLSTM), chunkwise-parallel form
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, d: int, *, n_heads: int,
               expand: int = 2, dtype=torch.bfloat16, device=None,
               lead: Tuple[int, ...] = ()):
    di = expand * d
    lead = tuple(lead)
    return {
        "up": dense_init(generator, d, 2 * di, dtype, device, lead),
        "wq": dense_init(generator, di, di, dtype, device, lead),
        "wk": dense_init(generator, di, di, dtype, device, lead),
        "wv": dense_init(generator, di, di, dtype, device, lead),
        "w_if": dense_init(generator, di, 2 * n_heads, torch.float32,
                           device, lead),
        "ln_scale": torch.zeros(lead + (di,), dtype=torch.float32,
                                device=device),
        "down": dense_init(generator, di, d, dtype, device, lead),
    }


def mlstm_state_init(batch: int, d: int, *, n_heads: int, expand: int = 2,
                     device=None):
    di = expand * d
    hd = di // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, hd, hd), **f32),
            "n": torch.zeros((batch, n_heads, hd), **f32),
            "m": torch.full((batch, n_heads), -1e30, **f32)}


def _mlstm_chunk(q, k, v, log_i, log_f, C0, n0, m0):
    """One chunk of stabilised chunkwise mLSTM.

    q/k/v: (B, H, W, hd); log_i/log_f: (B, H, W) f32. State (C0, n0, m0).
    Returns (h (B, H, W, hd) f32, C1, n1, m1)."""
    W, hd = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    b = torch.cumsum(log_f, dim=-1)                         # inclusive
    # intra-chunk log-weights A[t, s] = b_t − b_s + ι_s for s ≤ t; the
    # masked entries are -inf before exp, never a mask times exp(-inf)
    mask = torch.ones((W, W), dtype=torch.bool, device=q.device).tril()
    A = torch.where(mask, b[..., :, None] - b[..., None, :]
                    + log_i[..., None, :], -torch.inf)
    m_intra = A.amax(dim=-1)                                # (B, H, W)
    m_inter = b + m0[..., None]
    m_t = torch.maximum(m_intra, m_inter)
    qf, kf, vf = q.float(), k.float(), v.float()
    S = (qf @ kf.transpose(-1, -2)) * scale
    P = torch.where(mask, S * torch.exp(A - m_t[..., None]), 0.0)
    h_intra = P @ vf
    dec = torch.exp(m_inter - m_t)[..., None]               # (B, H, W, 1)
    qs = qf * scale
    h_inter = (qs @ C0) * dec
    n_q = (qs @ n0[..., None]) * dec
    num = h_intra + h_inter
    den_vec = P.sum(-1, keepdim=True) + n_q
    den = torch.maximum(den_vec.abs(), torch.exp(-m_t)[..., None])
    h = num / den
    bW = b[..., -1:]
    m1 = torch.maximum(bW + m0[..., None],
                       (bW - b + log_i).amax(dim=-1, keepdim=True))
    w_upd = torch.exp(bW - b + log_i - m1)                  # (B, H, W)
    dec1 = torch.exp(bW + m0[..., None] - m1)               # (B, H, 1)
    kw = w_upd[..., None] * kf
    C1 = dec1[..., None] * C0 + kw.transpose(-1, -2) @ vf
    n1 = dec1 * n0 + kw.sum(dim=-2)
    return h, C1, n1, m1[..., -1]


def _mlstm_heads(p, x: torch.Tensor, state=None, chunk: int = 128):
    """The mLSTM block up to its norm, on the heads ``p`` holds (all, or a
    rank's): returns (h (B, S, H hd) in ``x``'s dtype, z (B, S, H hd),
    new state)."""
    B, S, D = x.shape
    di = p["wq"].shape[0]                  # u's width: every channel
    H = p["w_if"].shape[1] // 2
    hd = p["wq"].shape[1] // H
    uz = x @ p["up"]
    u, z = uz.split([di, uz.shape[-1] - di], dim=-1)

    def heads(w):                                           # (B, H, S, hd)
        return (u @ w).reshape(B, S, H, hd).transpose(1, 2)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gates = (u.float() @ p["w_if"]).transpose(1, 2)         # (B, 2H, S)
    log_i, log_f = gates[:, :H], _log_sigmoid(gates[:, H:])
    W = _chunk_width(S, chunk)
    if state is None:
        state = mlstm_state_init(B, H * hd, n_heads=H, expand=1,
                                 device=x.device)
    C_, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c in range(S // W):
        sl = slice(c * W, (c + 1) * W)
        h, C_, n, m = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                   log_i[..., sl], log_f[..., sl], C_, n, m)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
    return h.to(x.dtype), z, {"C": C_, "n": n, "m": m}


def _sq_sum(h: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of each row of ``h`` (B, S, 1)."""
    hf = h.float()
    return (hf * hf).sum(-1, keepdim=True)


def _norm_with(h: torch.Tensor, ss: torch.Tensor, n: int,
               scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of ``h`` given the sums of squares ``ss`` of its rows'
    ``n`` elements (``h`` may hold a share of them)."""
    out = h.float() * torch.rsqrt(ss / n + eps) * (1.0 + scale.float())
    return out.to(h.dtype)


def _norm_over(h: torch.Tensor, scale: torch.Tensor, group,
               eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` over the whole ``di`` of a rank's channels ``h``: the
    sums of squares summed over ``group`` (one device: ``rms_norm``)."""
    if group is None:
        return rms_norm(h, scale, eps)
    n = h.shape[-1] * torch.distributed.get_world_size(group)
    return _norm_with(h, _summed(_sq_sum(h), group), n, scale, eps)


def mlstm_seq(p, x: torch.Tensor, state=None, chunk: int = 128,
              group=None, seq: bool = False):
    """Full-sequence mLSTM block. x (B, S, D) → (y (B, S, D), new_state).
    On a tensor-parallel ``group`` the params and state are the rank's
    heads (see the module's docstring)."""
    x = _enter(x, group, seq)
    h, z, st = _mlstm_heads(p, x, state, chunk)
    y = _norm_over(h, p["ln_scale"], group) * F.silu(z)
    return _leave(y @ p["down"], group, seq), st


def mlstm_step(p, x: torch.Tensor, state, group=None):
    return mlstm_seq(p, x, state, chunk=1, group=group)


# ---------------------------------------------------------------------------
# sLSTM — scalar-memory LSTM with exponential gating (recurrent only)
# ---------------------------------------------------------------------------

def slstm_init(generator: torch.Generator, d: int, *, n_heads: int,
               expand: int = 2, dtype=torch.bfloat16, device=None,
               lead: Tuple[int, ...] = ()):
    di = expand * d
    hd = di // n_heads
    lead = tuple(lead)
    r = torch.randn(lead + (n_heads, hd, 4 * hd), generator=generator,
                    dtype=torch.float32, device=device)
    return {
        "up": dense_init(generator, d, di, dtype, device, lead),
        "w_gates": dense_init(generator, di, 4 * di, dtype, device,
                              lead),                        # i, f, z, o
        "r_gates": (r / math.sqrt(hd)).to(dtype),          # per head
        "down": dense_init(generator, di, d, dtype, device, lead),
    }


def slstm_state_init(batch: int, d: int, *, n_heads: int, expand: int = 2,
                     device=None):
    di = expand * d
    hd = di // n_heads
    f32 = dict(dtype=torch.float32, device=device)

    def z():
        return torch.zeros((batch, n_heads, hd), **f32)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, n_heads, hd), -1e30, **f32)}


def _slstm_cell(p, gx_t: torch.Tensor, st, n_heads: int, hd: int):
    """One sLSTM step. gx_t (B, H, 4 hd): the token's input gates
    ``u_t @ w_gates`` in the params' dtype; state tree of (B, H, hd)."""
    r = p["r_gates"]
    gh = (st["h"].to(r.dtype).transpose(0, 1) @ r).transpose(0, 1)
    g = (gx_t + gh).float()
    gi, gf, gz, go = g.chunk(4, dim=-1)                     # (B, H, hd)
    log_f = _log_sigmoid(gf)
    m_new = torch.maximum(log_f + st["m"], gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + st["m"] - m_new)
    c = f * st["c"] + i * torch.tanh(gz)
    n = f * st["n"] + i
    # maximum, not clamp: n is exactly 1 after the first step, and the
    # reference's gradient splits there
    h = torch.sigmoid(go) * c / torch.maximum(n, torch.ones_like(n))
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_seq(p, x: torch.Tensor, state=None, group=None,
              seq: bool = False):
    """Sequential sLSTM (a non-linear recurrence has no parallel form). On
    a tensor-parallel ``group`` the params and state are the rank's heads
    (see the module's docstring): the heads never mix, so the recurrence
    needs no exchange."""
    x = _enter(x, group, seq)
    B, S, D = x.shape
    H, hd = p["r_gates"].shape[0], p["r_gates"].shape[2] // 4
    u = x @ p["up"]
    st = (slstm_state_init(B, H * hd, n_heads=H, expand=1, device=x.device)
          if state is None else state)
    gx = (u @ p["w_gates"]).reshape(B, S, H, 4 * hd)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, gx[:, t], st, H, hd)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).reshape(B, S, H * hd)
    return _leave(h.to(x.dtype) @ p["down"], group, seq), st


def slstm_step(p, x: torch.Tensor, state, group=None):
    return slstm_seq(p, x, state, group=group)
