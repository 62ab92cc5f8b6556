"""Ragged (dropless) grouped MoE expert FFN on Hopper.

Replaces the TPU kernel ``repro.kernels.ragged_moe_ffn.ragged_moe_ffn_pallas``
(``src/repro/kernels/ragged_moe_ffn.py:101``) with the hand-written CUDA C++
kernels in ``csrc/ragged_moe_ffn.cu``. The layout is the same:

* tokens arrive as one flat buffer ``(T, D)``, sorted by expert, each
  expert's segment zero-padded up to a multiple of the row tile ``bm``;
* ``tile_group`` (``n_tiles = T // bm``) holds the owning expert per tile,
  the sentinel ``E`` for tiles past the occupied prefix. Sentinel tiles
  skip both products and come out exactly zero.

``ragged_tile_metadata`` builds the layout from per-expert segment sizes
with tensor ops only (cumsum + searchsorted, int32 throughout), so the plan
never synchronises the host: sizes are data-dependent *values* inside
static worst-case shapes.

On a CUDA tensor :func:`ragged_moe_ffn` launches the kernel or raises; the
CPU path lives in :mod:`.ops`, which sends CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["ragged_tile_metadata", "ragged_n_tiles", "ragged_moe_ffn",
           "ROW_BLOCK"]

#: Rows per thread block of the CUDA kernels (``RB`` in the source). The
#: plan's row tile ``bm`` must be a multiple of it, so that every block
#: belongs to exactly one expert.
ROW_BLOCK = 64


def ragged_n_tiles(n_assign: int, n_groups: int, bm: int) -> int:
    """Static worst-case (bm, D)-tile count for ``n_assign`` rows split over
    ``n_groups`` segments, each padded to a multiple of ``bm``:
    sum_g ceil(s_g / bm) <= floor(A / bm) + G."""
    return n_assign // bm + n_groups


def ragged_tile_metadata(sizes: torch.Tensor, bm: int, n_tiles: int):
    """Group-aligned ragged layout from per-group segment sizes.

    ``sizes``: (G,) routed-token count per group. Returns ``row_offsets``
    (G + 1,) int32 — where each group's segment starts in the flat buffer —
    and ``tile_group`` (n_tiles,) int32 — owning group per tile, sentinel
    ``G`` past the occupied prefix. A group with ``sizes[g] == 0`` owns no
    tiles. ``searchsorted(..., right=True)`` is JAX's ``side="right"``.
    """
    sizes = sizes.to(torch.int32)
    padded = torch.div(sizes + bm - 1, bm, rounding_mode="floor") * bm
    row_offsets = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=sizes.device),
        torch.cumsum(padded, 0, dtype=torch.int32)])
    tile_cum = torch.div(row_offsets[1:], bm, rounding_mode="floor")
    tile_group = torch.searchsorted(
        tile_cum, torch.arange(n_tiles, dtype=torch.int32,
                               device=sizes.device), right=True)
    return row_offsets, tile_group.to(torch.int32)


def _lib():
    lib = build.load("ragged_moe_ffn")
    fn = lib.ragged_moe_ffn_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def ragged_moe_ffn(w1, w3, w2, toks, tile_group):
    """Launch the CUDA grouped SwiGLU FFN. toks (T, D) bf16 group-sorted,
    tile_group (T // bm,) int32, w1/w3 (E, D, F), w2 (E, F, D) bf16 →
    (T, D) bf16.

    Two launches on the current stream: gate/up into a bf16 scratch
    ``h (T, F)``, then the down projection. Checks device, dtype, shape
    and contiguity and raises on what the kernel does not take; raises if
    the launch is refused. Adds one to ``ragged_moe_ffn.launches``.
    """
    tensors = {"w1": w1, "w3": w3, "w2": w2, "toks": toks}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"ragged_moe_ffn: {name} is not on a CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ragged_moe_ffn: {name} is {t.dtype}; the CUDA "
                            "kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"ragged_moe_ffn: {name} is not contiguous")
    if tile_group.dtype != torch.int32 or not tile_group.is_cuda \
            or not tile_group.is_contiguous():
        raise TypeError("ragged_moe_ffn: tile_group must be a contiguous "
                        "int32 CUDA tensor")
    devs = {t.device for t in tensors.values()} | {tile_group.device}
    if len(devs) != 1:
        raise ValueError(f"ragged_moe_ffn: tensors on several devices {devs}")
    T, D = toks.shape
    E, D1, F = w1.shape
    n_tiles = tile_group.shape[0]
    if w3.shape != (E, D, F) or w2.shape != (E, F, D) or D1 != D:
        raise ValueError(f"ragged_moe_ffn: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w3.shape)}, {tuple(w2.shape)} do not fit "
                         f"toks {tuple(toks.shape)}")
    if n_tiles == 0 or T % n_tiles:
        raise ValueError(f"ragged_moe_ffn: T={T} is not a multiple of "
                         f"{n_tiles} tiles")
    bm = T // n_tiles
    if bm % ROW_BLOCK:
        raise ValueError(f"ragged_moe_ffn: row tile bm={bm} must be a "
                         f"multiple of {ROW_BLOCK} on CUDA")
    out = torch.empty_like(toks)
    h = torch.empty((T, F), dtype=toks.dtype, device=toks.device)
    stream = torch.cuda.current_stream(toks.device).cuda_stream
    err = _lib().ragged_moe_ffn_bf16(
        toks.data_ptr(), tile_group.data_ptr(), w1.data_ptr(),
        w3.data_ptr(), w2.data_ptr(), h.data_ptr(), out.data_ptr(),
        T, D, F, E, bm, stream)
    if err != 0:
        raise RuntimeError(f"ragged_moe_ffn: CUDA launch failed with "
                           f"cudaError {err}")
    ragged_moe_ffn.launches += 1
    return out


ragged_moe_ffn.launches = 0
