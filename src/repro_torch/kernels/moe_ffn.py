"""Capacity-bucket grouped MoE expert FFN on Hopper.

Replaces the TPU kernel ``repro.kernels.moe_ffn.fused_moe_ffn_pallas``
(``src/repro/kernels/moe_ffn.py:57``) with the hand-written CUDA C++ kernels
in ``csrc/moe_ffn.cu``. The contract is the same: ``toks (E, C, D)`` holds
``C`` bucket rows per expert, unused rows zero, and each expert's rows go
through its own SwiGLU FFN. The kernel masks the ragged edges of C, D and F
itself, so nothing is padded per call (the reference wrapper pads C and F).
Two routes, picked from shapes and pointers, never by catching a failure:
the TMA route (a TMA ring and ``wgmma``, ``csrc/moe_ffn_hopper.cuh``) for D
and F multiples of 8 and 16-byte aligned operands, with a row block sized
to C (:func:`tma_rows`); the general route (WMMA,
``csrc/moe_ffn_blocks.cuh``) for every other shape.

On a CUDA tensor :func:`fused_moe_ffn` launches the kernel or raises; the
CPU path lives in :mod:`.ops`, which sends CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, costs
from .ragged_moe_ffn import check_operands, pick_route

__all__ = ["fused_moe_ffn", "fused_outputs", "tma_rows"]


def _lib():
    lib = build.load("moe_ffn")
    if lib.moe_ffn_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_ffn_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.moe_ffn_tma_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.moe_ffn_bf16.restype = ctypes.c_int
        lib.moe_ffn_tma_bf16.restype = ctypes.c_int
    return lib


def tma_rows(C: int) -> int:
    """Row block of the TMA route for buckets of C rows: 8 or 16 for
    C <= 16 (A and B swapped: one CTA per expert reads its weight slice
    once), else 64 or 128 rows a CTA."""
    for rows in (8, 16, 64):
        if C <= rows:
            return rows
    return 128


def fused_outputs(w1, w3, w2, toks, kind: str = "cuda"):
    """The call's checks and allocations on a device of type ``kind``
    (``meta`` for a traced call): raises on what the kernel does not take,
    returns ``(out (E, C, D), h (E, C, F))`` uninitialised (``h`` the bf16
    scratch of gate/up) and reports the call's entry (:mod:`.costs`:
    ``6 E C D F`` operations over every bucket row)."""
    check_operands("fused_moe_ffn",
                   {"w1": w1, "w3": w3, "w2": w2, "toks": toks}, kind)
    if toks.dim() != 3 or w1.dim() != 3:
        raise ValueError(f"fused_moe_ffn: toks {tuple(toks.shape)} and w1 "
                         f"{tuple(w1.shape)} must be 3-d")
    E, C, D = toks.shape
    F = w1.shape[-1]
    if w1.shape != (E, D, F) or w3.shape != (E, D, F) \
            or w2.shape != (E, F, D):
        raise ValueError(f"fused_moe_ffn: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w3.shape)}, {tuple(w2.shape)} do not fit "
                         f"toks {tuple(toks.shape)}")
    if min(E, C, D, F) <= 0 or E > 65535:
        raise ValueError(f"fused_moe_ffn: sizes E={E}, C={C}, D={D}, F={F} "
                         "must be positive, E at most 65535 (grid z)")
    out = torch.empty_like(toks)
    h = torch.empty((E, C, F), dtype=toks.dtype, device=toks.device)
    costs.report("fused_moe_ffn", 6.0 * E * C * D * F,
                 costs.tensor_bytes(w1, w3, w2, toks, out, h, h))
    return out, h


def fused_moe_ffn(w1, w3, w2, toks, route=None):
    """Launch the CUDA capacity-bucket SwiGLU FFN. toks (E, C, D) bf16,
    w1/w3 (E, D, F), w2 (E, F, D) bf16 → (E, C, D) bf16.

    Two launches on the current stream: gate/up into a bf16 scratch
    ``h (E, C, F)``, then the down projection. ``route="general"``
    (:func:`~.ragged_moe_ffn.pick_route`) forces the general route, to
    time the routes apart; the path leaves it None. Checks device, dtype,
    shape and contiguity and raises on what the kernel does not take
    (:func:`fused_outputs`, which allocates); raises if the launch is
    refused. Adds one to ``fused_moe_ffn.launches``
    and, on the TMA route, to ``fused_moe_ffn.tma_launches``.
    """
    out, h = fused_outputs(w1, w3, w2, toks)
    E, C, D = toks.shape
    F = w1.shape[-1]
    tma = pick_route("fused_moe_ffn", route, (w1, w3, w2, toks))
    stream = torch.cuda.current_stream(toks.device).cuda_stream
    lib = _lib()
    if tma:
        rows = tma_rows(C)
        err = lib.moe_ffn_tma_bf16(
            toks.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            h.data_ptr(), out.data_ptr(), E, C, D, F, rows, stream)
    else:
        err = lib.moe_ffn_bf16(
            toks.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            h.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    if err != 0:
        raise RuntimeError(f"fused_moe_ffn: CUDA launch failed with "
                           f"cudaError {err}")
    fused_moe_ffn.launches += 1
    fused_moe_ffn.tma_launches += tma
    fused_moe_ffn.last_route = f"tma rows={rows}" if tma else "general"
    return out


fused_moe_ffn.launches = 0
fused_moe_ffn.tma_launches = 0
fused_moe_ffn.last_route = None
