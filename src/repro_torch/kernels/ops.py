"""Public kernel entry points: the dispatch between kernel and plain version.

A tensor on the CPU goes to the plain PyTorch version (:mod:`.ref`); a
tensor on a CUDA device goes to the hand-written kernel, which launches or
raises. Nothing here catches a kernel failure to fall back to the plain
version. Each kernel wrapper keeps a plain integer launch count
(``launch_counts``), which only a kernel launch raises.

``FFN_TILES`` states the tiles of the CUDA FFN kernels' general route,
chosen for Hopper shared memory in place of the v5e VMEM budget the TPU
wrapper sized for (``pick_blocks`` in ``src/repro/kernels/ops.py:24-41``).
The TMA route's tiles and shared-memory plan live in
``csrc/moe_ffn_hopper.cuh`` alone (``Cfg``), which asserts at compile time
that each variant fits a block and two fit an SM.
"""

from __future__ import annotations

from typing import Dict

from . import moe_ffn as _capacity
from . import ragged_moe_ffn as _ragged
from . import ref
from . import route_select as _route

__all__ = ["fused_moe_ffn", "ragged_moe_ffn", "router_topk", "route_select",
           "FFN_TILES", "launch_counts", "reset_launch_counts"]

#: (RB, BN, BK) of both FFN kernels' general route
#: (``csrc/moe_ffn_blocks.cuh``, WMMA): RB rows x BN columns per block,
#: BK-deep reduction steps. Static shared memory per block: the x tile
#: RB x (BK + 8) bf16, two weight tiles BK x (BN + 8) bf16 and the f32
#: epilogue tile RB x (BN + 4): 31.7 KB, inside the 48 KB a block may take
#: statically.
FFN_TILES = (_ragged.ROW_BLOCK, 64, 32)


def fused_moe_ffn(w1, w3, w2, toks):
    """Capacity-bucket grouped SwiGLU FFN: toks (E, C, D) → (E, C, D)."""
    kind = toks.device.type
    if kind == "cpu":
        return ref.moe_ffn_ref(w1, w3, w2, toks)
    if kind == "cuda":
        return _capacity.fused_moe_ffn(w1, w3, w2, toks)
    raise ValueError(f"fused_moe_ffn: no kernel for device {toks.device}")


def ragged_moe_ffn(w1, w3, w2, toks, tile_group, row_offsets=None,
                   sizes=None, max_rows=None):
    """Ragged grouped SwiGLU FFN over a flat group-sorted (T, D) buffer
    and per-tile expert ids; the row tile is ``T // len(tile_group)``.
    ``row_offsets`` and ``sizes`` (the layout's segment starts and the
    plan's real rows per expert) let the kernel skip padding rows;
    ``max_rows`` (the most a tile is expected to hold) picks its row block
    and is never trusted. The plain version needs none of them: padding
    rows are zero."""
    kind = toks.device.type
    if kind == "cpu":
        return ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tile_group)
    if kind == "cuda":
        return _ragged.ragged_moe_ffn(w1, w3, w2, toks, tile_group,
                                      row_offsets=row_offsets, sizes=sizes,
                                      max_rows=max_rows)
    raise ValueError(f"ragged_moe_ffn: no kernel for device {toks.device}")


def router_topk(logits, top_k: int):
    """Softmax → top-k → renormalize: (T, E) → ((T, K) f32, (T, K) i32).
    On the card the logits-in entry of ``csrc/route_select.cu``."""
    kind = logits.device.type
    if kind == "cpu":
        return ref.router_topk_ref(logits, top_k)
    if kind == "cuda":
        return _route.router_topk(logits, top_k)
    raise ValueError(f"router_topk: no kernel for device {logits.device}")


def route_select(x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                 top_k: int, row_valid=None):
    """A layer's routing stage — f32 router product, softmax, top-k,
    replica selection, masked tally, mean probabilities, aux loss — in one
    launch: → ``(weights, idx, slots, tally (E + 1,), mean_prob, aux)``
    (:func:`~.ref.route_select_ref`)."""
    kind = x.device.type
    if kind == "cpu":
        return ref.route_select_ref(x, router_w, slots_of, n_copies,
                                    copy_cdf, route_seed, top_k, row_valid)
    if kind == "cuda":
        return _route.route_select(x, router_w, slots_of, n_copies,
                                   copy_cdf, route_seed, top_k, row_valid)
    raise ValueError(f"route_select: no kernel for device {x.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name; ``<name>.tma``
    counts those of an FFN kernel's launches that took the TMA route."""
    return {"fused_moe_ffn": _capacity.fused_moe_ffn.launches,
            "fused_moe_ffn.tma": _capacity.fused_moe_ffn.tma_launches,
            "ragged_moe_ffn": _ragged.ragged_moe_ffn.launches,
            "ragged_moe_ffn.tma": _ragged.ragged_moe_ffn.tma_launches,
            "router_topk": _route.router_topk.launches,
            "route_select": _route.route_select.launches}


def reset_launch_counts() -> None:
    for fn in (_capacity.fused_moe_ffn, _ragged.ragged_moe_ffn):
        fn.launches = 0
        fn.tma_launches = 0
    _route.router_topk.launches = 0
    _route.route_select.launches = 0
