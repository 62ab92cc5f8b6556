"""Fused softmax + top-k router gating, a Triton kernel for Hopper.

Replaces the TPU kernel ``repro.kernels.router.router_topk_pallas``
(``src/repro/kernels/router.py:46``): f32 softmax over the E logits of a
row, then K max / first-argmax / mask sweeps, then the selected weights
divided by their sum clamped at 1e-9.

Why Triton: the work is a row-wise softmax plus K reductions over at most
128 columns, with no matrix product — the fused reduction Triton is meant
for. What bounds it on an H100: launch latency and the ``T·E·4`` bytes of
logits it reads (``T·K·8`` written); at the slice's 4096 x 40 that is
0.66 MB + 0.26 MB, under a microsecond at 3.35 TB/s, so one launch costs
more than the traffic.

Design: one program per ``BLOCK_T`` rows; E padded to a power of two,
padded columns at -inf before the softmax and -1 after it, so they never
win a sweep. The winner of a sweep is the *smallest* column equal to the
row maximum (``min(where(p == max, col, BLOCK_E))``), the tie rule of
``lax.top_k``; ``tl.argmax``'s tie order is not documented.

``triton`` is imported on the first launch, never at module import, so the
CPU tests import this module on a host without it.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["router_topk"]

#: ``triton.language``, bound on the first launch (the kernel body below
#: is compiled then, and resolves ``tl`` from this module's globals).
tl = None


def _router_topk_kernel(logits_ptr, w_ptr, idx_ptr, T, E,
                        K: tl.constexpr, KP: tl.constexpr,
                        BLOCK_T: tl.constexpr, BLOCK_E: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
    cols = tl.arange(0, BLOCK_E)
    kcols = tl.arange(0, KP)
    rmask = rows < T
    cmask = cols < E
    x = tl.load(logits_ptr + rows[:, None] * E + cols[None, :],
                mask=rmask[:, None] & cmask[None, :], other=0.0)
    x = tl.where(cmask[None, :], x, float("-inf"))
    m = tl.max(x, axis=1)
    e = tl.exp(x - m[:, None])
    p = e / tl.sum(e, axis=1)[:, None]
    p = tl.where(cmask[None, :], p, -1.0)
    total = tl.zeros((BLOCK_T,), dtype=tl.float32)
    w_sel = tl.zeros((BLOCK_T, KP), dtype=tl.float32)
    i_sel = tl.zeros((BLOCK_T, KP), dtype=tl.int32)
    for k in tl.static_range(K):
        mx = tl.max(p, axis=1)
        win = tl.min(tl.where(p == mx[:, None], cols[None, :], BLOCK_E),
                     axis=1)
        w_sel = tl.where(kcols[None, :] == k, mx[:, None], w_sel)
        i_sel = tl.where(kcols[None, :] == k, win[:, None], i_sel)
        total += mx
        p = tl.where(cols[None, :] == win[:, None], -1.0, p)
    w_sel = w_sel / tl.maximum(total, 1e-9)[:, None]
    omask = rmask[:, None] & (kcols[None, :] < K)
    offs = rows[:, None] * K + kcols[None, :]
    tl.store(w_ptr + offs, w_sel, mask=omask)
    tl.store(idx_ptr + offs, i_sel, mask=omask)


@functools.lru_cache(maxsize=None)
def _compiled():
    global tl
    import triton
    import triton.language
    tl = triton.language
    return triton.jit(_router_topk_kernel)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def router_topk(logits: torch.Tensor, top_k: int):
    """Launch the Triton router. logits (T, E) f32 contiguous CUDA →
    (weights (T, K) f32, idx (T, K) int32). Raises on what it does not
    take. Adds one to ``router_topk.launches``."""
    if not logits.is_cuda:
        raise ValueError("router_topk: logits are not on a CUDA device")
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or not logits.is_contiguous():
        raise TypeError("router_topk: logits must be a contiguous (T, E) "
                        f"float32 tensor, got {logits.dtype} "
                        f"{tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= top_k <= E or E > 1024:
        raise ValueError(f"router_topk: top_k={top_k} with E={E}")
    w = torch.empty((T, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return w, idx
    block_t = 32
    kernel = _compiled()
    kernel[(-(-T // block_t),)](logits, w, idx, T, E, K=top_k,
                                KP=_pow2(top_k), BLOCK_T=block_t,
                                BLOCK_E=max(_pow2(E), 16), num_warps=4)
    router_topk.launches += 1
    return w, idx


router_topk.launches = 0
