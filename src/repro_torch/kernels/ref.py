"""Plain PyTorch versions of the kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each hand-written
kernel against them on the card. They repeat the kernels' arithmetic
(f32 accumulation, the hidden activation rounded to the input dtype before
the down projection) and are no yardstick of speed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_ffn_ref", "ragged_moe_ffn_ref", "router_topk_ref"]


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


def router_topk_ref(logits, top_k: int):
    """Softmax → top-k → renormalize. logits (T, E) → ((T,K) f32, (T,K) i32).

    Top-k is K masked argmax sweeps, as the Pallas kernel does it:
    ``torch.argmax`` returns the first maximal index (the tie rule of
    ``lax.top_k``), while ``torch.topk``'s tie order is unspecified.
    """
    p = torch.softmax(logits.float(), dim=-1)
    ws, ids = [], []
    for _ in range(top_k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        ws.append(torch.gather(p, -1, i))
        ids.append(i)
        p = p.scatter(-1, i, -1.0)
    w = torch.cat(ws, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, torch.cat(ids, dim=-1).to(torch.int32)
