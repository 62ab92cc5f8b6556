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

The gradient is two kernels of ``csrc/moe_ffn_bwd.cu`` over the buckets,
on the TMA route only: :func:`moe_ffn_dgrad` (K1: ``dx`` and the bf16
``da``, ``db``) and :func:`moe_ffn_wgrad` (K2: the three weight gradients,
each bucket's rows summed in a fixed order). They are the ragged
backward's kernels (``csrc/moe_ffn_hopper_bwd.cuh``) over the bucket
layout. The forward's bf16 scratch ``h (E, C, F)`` is the saved
activation (``keep_h=True``). :class:`repro_torch.kernels.ops.FusedMoeFFN`
ties them together for autograd.

On a CUDA tensor each wrapper launches its kernel or raises; the CPU path
lives in :mod:`.ops`, which sends CPU tensors to the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, costs
from .ragged_moe_ffn import check_operands, pick_route, tma_ok

__all__ = ["fused_moe_ffn", "fused_outputs", "tma_rows", "moe_ffn_dgrad",
           "moe_ffn_wgrad", "bwd_rows", "dgrad_plan", "wgrad_plan",
           "dgrad_outputs", "wgrad_outputs"]


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


def fused_moe_ffn(w1, w3, w2, toks, route=None, keep_h=False):
    """Launch the CUDA capacity-bucket SwiGLU FFN. toks (E, C, D) bf16,
    w1/w3 (E, D, F), w2 (E, F, D) bf16 → (E, C, D) bf16.

    Two launches on the current stream: gate/up into a bf16 scratch
    ``h (E, C, F)``, then the down projection. ``route="general"``
    (:func:`~.ragged_moe_ffn.pick_route`) forces the general route, to
    time the routes apart; the path leaves it None. Checks device, dtype,
    shape and contiguity and raises on what the kernel does not take
    (:func:`fused_outputs`, which allocates); raises if the launch is
    refused. Adds one to ``fused_moe_ffn.launches``
    and, on the TMA route, to ``fused_moe_ffn.tma_launches``. ``keep_h``
    returns ``(out, h)``: the scratch, written on every bucket row, is the
    backward's saved activation.
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
    return (out, h) if keep_h else out


fused_moe_ffn.launches = 0
fused_moe_ffn.tma_launches = 0
fused_moe_ffn.last_route = None


def bwd_rows(C: int) -> int:
    """Row block of the bucket K1: 128 (two consumer warpgroups, one CTA
    an SM) where a bucket holds at least 128 rows, else 64."""
    return 128 if C >= 128 else 64


def _bucket_shapes(kernel, toks, **named):
    """``(E, C, D)`` of the buckets ``toks``, raising unless every tensor
    of ``named`` (name → (tensor, shape)) has its shape."""
    if toks.dim() != 3:
        raise ValueError(f"{kernel}: toks {tuple(toks.shape)} must be "
                         "(E, C, D)")
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)}, not "
                             f"{shape} beside toks {tuple(toks.shape)}")
    return tuple(toks.shape)


def _tma_only(kernel, tensors: dict) -> None:
    """Raise a ValueError naming the shapes unless a TMA descriptor
    describes every operand (:func:`~.ragged_moe_ffn.tma_ok`): the
    backward has the TMA route only."""
    if not tma_ok(*tensors.values()):
        shapes = ", ".join(f"{k} {tuple(t.shape)}"
                           for k, t in tensors.items())
        raise ValueError(f"{kernel}: the backward takes D and F multiples "
                         f"of 8 and 16-byte aligned operands, not {shapes}")


def dgrad_plan(w1, w3, w2, toks, dy):
    """``(E, C, D, F, rows)`` of a bucket K1 call, from shapes and pointers
    alone (no launch, no card): ``rows`` the row block (:func:`bwd_rows`).
    Raises ValueError on shapes the kernel does not take."""
    kernel = "moe_ffn_dgrad"
    E, C, D = _bucket_shapes(kernel, toks, dy=(dy, tuple(toks.shape)))
    F = w1.shape[-1]
    _bucket_shapes(kernel, toks, w1=(w1, (E, D, F)), w3=(w3, (E, D, F)),
                   w2=(w2, (E, F, D)))
    if min(E, C, D, F) <= 0 or E > 65535:
        raise ValueError(f"{kernel}: sizes E={E}, C={C}, D={D}, F={F} must "
                         "be positive, E at most 65535 (grid z)")
    _tma_only(kernel, {"w1": w1, "w3": w3, "w2": w2, "toks": toks,
                       "dy": dy})
    return E, C, D, F, bwd_rows(C)


def wgrad_plan(toks, h, da, db, dy):
    """``(E, C, D, F)`` of a bucket K2 call, from shapes and pointers
    alone. Raises ValueError on shapes the kernel does not take."""
    kernel = "moe_ffn_wgrad"
    E, C, D = _bucket_shapes(kernel, toks, dy=(dy, tuple(toks.shape)))
    F = h.shape[-1]
    _bucket_shapes(kernel, toks, h=(h, (E, C, F)), da=(da, (E, C, F)),
                   db=(db, (E, C, F)))
    if min(E, C, D, F) <= 0 or E > 65535:
        raise ValueError(f"{kernel}: sizes E={E}, C={C}, D={D}, F={F} must "
                         "be positive, E at most 65535 (grid z)")
    _tma_only(kernel, {"toks": toks, "h": h, "da": da, "db": db, "dy": dy})
    return E, C, D, F


def dgrad_outputs(w1, w3, w2, toks, dy, kind: str = "cuda"):
    """K1's checks and allocations on a device of type ``kind`` (``meta``
    for a traced call): ``((dx (E, C, D), da (E, C, F), db (E, C, F)),
    plan)``, uninitialised, the plan :func:`dgrad_plan`'s; reports the
    call's entry (``10 E C D F``: gate/up again, ``dy W2ᵀ``,
    ``da W1ᵀ + db W3ᵀ``, over every bucket row)."""
    check_operands("moe_ffn_dgrad", {"w1": w1, "w3": w3, "w2": w2,
                                     "toks": toks, "dy": dy}, kind)
    plan = dgrad_plan(w1, w3, w2, toks, dy)
    E, C, D, F = plan[:4]
    dx = torch.empty_like(toks)
    da = torch.empty((E, C, F), dtype=toks.dtype, device=toks.device)
    db = torch.empty_like(da)
    costs.report("moe_ffn_dgrad", 10.0 * E * C * D * F, costs.tensor_bytes(
        w1, w3, w2, toks, dy, dx, da, db))
    return (dx, da, db), plan


def wgrad_outputs(toks, h, da, db, dy, kind: str = "cuda"):
    """K2's checks and allocations on a device of type ``kind``:
    ``((dw1, dw3 (E, D, F), dw2 (E, F, D)), (E, C, D, F))``,
    uninitialised; reports the call's entry (``6 E C D F``)."""
    check_operands("moe_ffn_wgrad", {"toks": toks, "h": h, "da": da,
                                     "db": db, "dy": dy}, kind)
    plan = wgrad_plan(toks, h, da, db, dy)
    E, C, D, F = plan
    dw1 = torch.empty((E, D, F), dtype=toks.dtype, device=toks.device)
    dw3 = torch.empty_like(dw1)
    dw2 = torch.empty((E, F, D), dtype=toks.dtype, device=toks.device)
    costs.report("moe_ffn_wgrad", 6.0 * E * C * D * F, costs.tensor_bytes(
        toks, h, da, db, dy, dw1, dw3, dw2))
    return (dw1, dw3, dw2), plan


def _bwd_lib():
    lib = build.load("moe_ffn_bwd")
    if lib.moe_ffn_dgrad_tma_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_ffn_dgrad_tma_bf16.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.moe_ffn_wgrad_tma_bf16.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.moe_ffn_dgrad_tma_bf16.restype = ctypes.c_int
        lib.moe_ffn_wgrad_tma_bf16.restype = ctypes.c_int
    return lib


def moe_ffn_dgrad(w1, w3, w2, toks, dy):
    """Launch the bucket K1: ``dy (E, C, D)`` → ``(dx (E, C, D), da (E, C,
    F), db (E, C, F))`` bf16, as :func:`~.ref.moe_ffn_bwd_ref` computes
    ``dx`` and its rounded ``da``, ``db``, every bucket row (an empty row,
    x = 0 and dy = 0, comes out zero). The TMA route only: raises a
    ValueError on a D or F that is not a multiple of 8 or an operand that
    is not 16-byte aligned (:func:`dgrad_plan`), and a RuntimeError if the
    launch is refused. Adds one to ``moe_ffn_dgrad.launches`` and to
    ``moe_ffn_dgrad.tma_launches``."""
    (dx, da, db), (E, C, D, F, rows) = dgrad_outputs(w1, w3, w2, toks, dy)
    stream = torch._C._cuda_getCurrentRawStream(toks.get_device())
    err = _bwd_lib().moe_ffn_dgrad_tma_bf16(
        toks.data_ptr(), dy.data_ptr(), w1.data_ptr(), w3.data_ptr(),
        w2.data_ptr(), da.data_ptr(), db.data_ptr(), dx.data_ptr(), E, C, D,
        F, rows, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn_dgrad: CUDA launch failed with "
                           f"cudaError {err}")
    moe_ffn_dgrad.launches += 1
    moe_ffn_dgrad.tma_launches += 1
    moe_ffn_dgrad.last_route = f"tma rows={rows}"
    return dx, da, db


moe_ffn_dgrad.launches = 0
moe_ffn_dgrad.tma_launches = 0
moe_ffn_dgrad.last_route = None


def moe_ffn_wgrad(toks, h, da, db, dy):
    """Launch the bucket K2: ``(dw1 (E, D, F), dw3 (E, D, F), dw2 (E, F,
    D))`` bf16 = ``xᵀ da``, ``xᵀ db``, ``hᵀ dy`` over each bucket's C
    rows, summed in f32 in a fixed order (the rows of the next bucket that
    a 64-row chunk runs into are zeroed before they are read). The TMA
    route only, as :func:`moe_ffn_dgrad`. Adds one to
    ``moe_ffn_wgrad.launches`` and to ``moe_ffn_wgrad.tma_launches``."""
    (dw1, dw3, dw2), (E, C, D, F) = wgrad_outputs(toks, h, da, db, dy)
    stream = torch._C._cuda_getCurrentRawStream(toks.get_device())
    err = _bwd_lib().moe_ffn_wgrad_tma_bf16(
        toks.data_ptr(), h.data_ptr(), da.data_ptr(), db.data_ptr(),
        dy.data_ptr(), dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(), E, C,
        D, F, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn_wgrad: CUDA launch failed with "
                           f"cudaError {err}")
    moe_ffn_wgrad.launches += 1
    moe_ffn_wgrad.tma_launches += 1
    moe_ffn_wgrad.last_route = "tma"
    return dw1, dw3, dw2


moe_ffn_wgrad.launches = 0
moe_ffn_wgrad.tma_launches = 0
moe_ffn_wgrad.last_route = None
