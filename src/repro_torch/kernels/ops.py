"""Public kernel entry points: the dispatch between kernel and plain version.

A tensor on the CPU goes to the plain PyTorch version (:mod:`.ref`); a
tensor on a CUDA device goes to the hand-written kernel, which launches or
raises. Nothing here catches a kernel failure to fall back to the plain
version. Each kernel wrapper keeps a plain integer launch count
(``launch_counts``), which only a kernel launch raises.

``FFN_TILES`` states the CUDA FFN kernel's tiles, chosen for Hopper
shared memory in place of the v5e VMEM budget the TPU wrapper sized for.
"""

from __future__ import annotations

from typing import Dict

from . import ragged_moe_ffn as _ragged
from . import ref
from . import router as _router

__all__ = ["ragged_moe_ffn", "router_topk", "FFN_TILES", "launch_counts",
           "reset_launch_counts"]

#: Tiles of ``csrc/ragged_moe_ffn.cu`` (RB, BN, BK): RB rows x BN columns
#: per block, BK-deep reduction steps, the same for every (D, F) since the
#: kernel masks its edges. Shared memory per block: the x tile
#: RB x (BK + 8) bf16, two weight tiles BK x (BN + 8) bf16 and the f32
#: epilogue tile RB x (BN + 4): 31.7 KB, inside the 48 KB a block may take
#: statically, so several blocks share one SM's 227 KB and the 132 SMs stay
#: busy at decode's few occupied tiles. 8 warps each own a 16 x 32 output
#: slice (two 16x16x16 bf16 WMMA accumulators per product).
FFN_TILES = (_ragged.ROW_BLOCK, 64, 32)


def ragged_moe_ffn(w1, w3, w2, toks, tile_group):
    """Ragged grouped SwiGLU FFN over a flat group-sorted (T, D) buffer
    and per-tile expert ids; the row tile is ``T // len(tile_group)``."""
    kind = toks.device.type
    if kind == "cpu":
        return ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tile_group)
    if kind == "cuda":
        return _ragged.ragged_moe_ffn(w1, w3, w2, toks, tile_group)
    raise ValueError(f"ragged_moe_ffn: no kernel for device {toks.device}")


def router_topk(logits, top_k: int):
    """Softmax → top-k → renormalize: (T, E) → ((T, K) f32, (T, K) i32)."""
    kind = logits.device.type
    if kind == "cpu":
        return ref.router_topk_ref(logits, top_k)
    if kind == "cuda":
        return _router.router_topk(logits, top_k)
    raise ValueError(f"router_topk: no kernel for device {logits.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"ragged_moe_ffn": _ragged.ragged_moe_ffn.launches,
            "router_topk": _router.router_topk.launches}


def reset_launch_counts() -> None:
    _ragged.ragged_moe_ffn.launches = 0
    _router.router_topk.launches = 0
