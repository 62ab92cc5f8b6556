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

The kernel also takes the layout's ``row_offsets`` and the plan's
``sizes``, from which each CTA works out the real rows of its tile
(:func:`ragged_tile_rows` is the plain version of that rule), so it computes
only those rows; the plan needs no extra tensor op for it.

The backward is two kernels of ``csrc/ragged_moe_ffn_bwd.cu`` over the
same layout and real rows: :func:`ragged_moe_ffn_dgrad` (K1: ``dx`` and the
bf16 ``da``, ``db``) and :func:`ragged_moe_ffn_wgrad` (K2: the three weight
gradients, each expert's rows summed in a fixed order), each with the same
two routes as the forward (the TMA route in
``csrc/moe_ffn_hopper_bwd.cuh``). The forward's bf16
scratch ``h (T, F)`` is the saved activation (``keep_h=True``).
:class:`repro_torch.kernels.ops.RaggedMoeFFN` ties them together for
autograd.

On a CUDA tensor each wrapper launches its kernel or raises; the CPU path
lives in :mod:`.ops`, which sends CPU tensors to the plain versions.
Two routes, picked from shapes and pointers (:func:`pick_route`), never by
catching a failure: the TMA route (a TMA ring and ``wgmma``,
``csrc/moe_ffn_hopper.cuh``) for D and F multiples of 8 and 16-byte aligned
operands, the general route (WMMA, ``csrc/moe_ffn_blocks.cuh``) for every
other shape.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, costs

__all__ = ["ragged_tile_metadata", "ragged_tile_rows", "ragged_n_tiles",
           "ragged_moe_ffn", "ragged_moe_ffn_dgrad", "ragged_moe_ffn_wgrad",
           "tma_rows", "tma_ok", "check_operands", "pick_route", "bwd_rows",
           "dgrad_plan", "wgrad_plan", "ffn_outputs", "dgrad_outputs",
           "wgrad_outputs", "ROW_BLOCK"]

#: Rows per thread block of the general route (``RB`` in
#: ``moe_ffn_blocks.cuh``). The plan's row tile ``bm`` must be a multiple of
#: it, so that every block belongs to exactly one expert.
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


def ragged_tile_rows(row_offsets: torch.Tensor, sizes: torch.Tensor,
                     tile_group: torch.Tensor, bm: int) -> torch.Tensor:
    """Real rows of each tile (n_tiles,) int32, 0 on sentinels: tile ``i``
    of group ``g`` holds buffer rows ``[i bm, (i + 1) bm)``, of which those
    below ``row_offsets[g] + sizes[g]`` are real. The TMA route's CTAs
    compute the same from the two tensors; this plain version is for
    checks, not for the path."""
    G = sizes.shape[0]
    ends = torch.cat([row_offsets[:-1] + sizes.to(torch.int32),
                      row_offsets.new_zeros((1,))])
    starts = torch.arange(tile_group.shape[0], dtype=torch.int32,
                          device=tile_group.device) * bm
    return torch.clamp(ends[tile_group.clamp(max=G).long()] - starts, 0,
                       bm).to(torch.int32)


def tma_rows(max_rows, bm: int) -> int:
    """Row block of the TMA route: 8 or 16 where at most that many rows a
    tile are expected (A and B swapped, one CTA per tile), else one CTA
    per 128 (or, for a bm not a multiple of 128, 64) rows. ``max_rows`` is
    a hint only: a tile with more real rows is still computed whole."""
    if max_rows is not None and max_rows <= 8:
        return 8
    if max_rows is not None and max_rows <= 16:
        return 16
    return 128 if bm % 128 == 0 else 64


def tma_ok(*tensors) -> bool:
    """Whether a TMA descriptor describes every operand: the rows of each
    (its last dimension) a multiple of 16 bytes and its base 16-byte
    aligned."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


def check_operands(kernel: str, tensors: dict, kind: str = "cuda") -> None:
    """Raise unless every tensor of ``tensors`` (name → tensor) is a
    contiguous bfloat16 tensor, all on one device of type ``kind`` (a
    CUDA device; ``meta`` for a traced call, :mod:`.ops`)."""
    for name, t in tensors.items():
        if t.device.type != kind:
            where = "CUDA" if kind == "cuda" else kind
            raise ValueError(f"{kernel}: {name} is not on a {where} device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel}: {name} is {t.dtype}; the CUDA "
                            "kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    devs = {t.get_device() for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devs}")


def pick_route(kernel: str, route, tensors) -> bool:
    """Whether to take the TMA route: ``route`` None picks it when
    :func:`tma_ok`; "general" forces the general route, to time the two
    routes on the same inputs."""
    if route is None:
        return tma_ok(*tensors)
    if route == "general":
        return False
    raise ValueError(f"{kernel}: route {route!r} is neither None nor "
                     "'general'")


def _lib():
    lib = build.load("ragged_moe_ffn")
    if lib.ragged_moe_ffn_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ragged_moe_ffn_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            i, p]
        lib.ragged_moe_ffn_tma_bf16.argtypes = [p, p, p, p, p, p, p, p, p,
                                                i, i, i, i, i, i, p]
        lib.ragged_moe_ffn_bf16.restype = ctypes.c_int
        lib.ragged_moe_ffn_tma_bf16.restype = ctypes.c_int
    return lib


def _check_index(name, t, n, dev):
    if t.dtype != torch.int32 or not t.is_contiguous() \
            or t.shape != (n,) or t.device != dev:
        raise TypeError(f"ragged_moe_ffn: {name} must be a contiguous "
                        f"({n},) int32 tensor on {dev}")


def ffn_outputs(w1, w3, w2, toks, tile_group, row_offsets=None,
                sizes=None, kind: str = "cuda"):
    """The forward call's checks and allocations, on ``toks``' device of
    type ``kind`` (``meta`` for a traced call): raises on what the kernel
    does not take, returns ``(out (T, D), h (T, F), bm)`` uninitialised
    (``h`` is the bf16 scratch of gate/up) and reports the call's entry
    (:mod:`.costs`: ``6 T D F`` operations over the whole buffer)."""
    check_operands("ragged_moe_ffn",
                   {"w1": w1, "w3": w3, "w2": w2, "toks": toks}, kind)
    T, D = toks.shape
    E, D1, F = w1.shape
    n_tiles = tile_group.shape[0]
    _check_index("tile_group", tile_group, n_tiles, toks.device)
    if (row_offsets is None) != (sizes is None):
        raise ValueError("ragged_moe_ffn: give row_offsets and sizes "
                         "together")
    if sizes is not None:
        _check_index("row_offsets", row_offsets, E + 1, toks.device)
        _check_index("sizes", sizes, E, toks.device)
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
    costs.report("ragged_moe_ffn", 6.0 * T * D * F, costs.tensor_bytes(
        w1, w3, w2, toks, tile_group, row_offsets, sizes, out, h, h))
    return out, h, bm


def ragged_moe_ffn(w1, w3, w2, toks, tile_group, row_offsets=None,
                   sizes=None, max_rows=None, route=None, keep_h=False):
    """Launch the CUDA grouped SwiGLU FFN. toks (T, D) bf16 group-sorted,
    tile_group (T // bm,) int32, w1/w3 (E, D, F), w2 (E, F, D) bf16 →
    (T, D) bf16.

    ``row_offsets`` (E + 1,) and ``sizes`` (E,) int32, the layout's and
    the plan's, give each tile's real rows (:func:`ragged_tile_rows`); the
    TMA route computes only those (None: every tile full). ``max_rows`` is
    the most real rows a tile is expected to hold, a hint that picks the
    TMA route's row block (:func:`tma_rows`) and is never trusted.
    ``route="general"`` (:func:`pick_route`) forces the general route, to
    time the routes apart; the path leaves it None.

    Two launches on the current stream: gate/up into a bf16 scratch
    ``h (T, F)``, then the down projection. Checks device, dtype, shape
    and contiguity and raises on what the kernel does not take
    (:func:`ffn_outputs`, which allocates); raises if the launch is
    refused. Adds one to ``ragged_moe_ffn.launches`` and, on the TMA
    route, to ``ragged_moe_ffn.tma_launches``. ``keep_h`` returns
    ``(out, h)``: the scratch, written on every real row, is the
    backward's saved activation.
    """
    out, h, bm = ffn_outputs(w1, w3, w2, toks, tile_group, row_offsets,
                             sizes)
    T, D = toks.shape
    E, _, F = w1.shape
    tma = pick_route("ragged_moe_ffn", route, (w1, w3, w2, toks))
    stream = torch.cuda.current_stream(toks.device).cuda_stream
    lib = _lib()
    if tma:
        rows = tma_rows(max_rows, bm)
        err = lib.ragged_moe_ffn_tma_bf16(
            toks.data_ptr(), tile_group.data_ptr(),
            None if sizes is None else row_offsets.data_ptr(),
            None if sizes is None else sizes.data_ptr(),
            w1.data_ptr(), w3.data_ptr(), w2.data_ptr(), h.data_ptr(),
            out.data_ptr(), T, D, F, E, bm, rows, stream)
    else:
        err = lib.ragged_moe_ffn_bf16(
            toks.data_ptr(), tile_group.data_ptr(), w1.data_ptr(),
            w3.data_ptr(), w2.data_ptr(), h.data_ptr(), out.data_ptr(),
            T, D, F, E, bm, stream)
    if err != 0:
        raise RuntimeError(f"ragged_moe_ffn: CUDA launch failed with "
                           f"cudaError {err}")
    ragged_moe_ffn.launches += 1
    ragged_moe_ffn.tma_launches += tma
    ragged_moe_ffn.last_route = f"tma rows={rows}" if tma else "general"
    return (out, h) if keep_h else out


ragged_moe_ffn.launches = 0
ragged_moe_ffn.tma_launches = 0
ragged_moe_ffn.last_route = None


def bwd_rows(bm: int) -> int:
    """Row block of K1's TMA route: 128 (two consumer warpgroups, one CTA
    an SM) where the row tile ``bm`` is a multiple of 128, else 64 (one
    warpgroup, two CTAs an SM)."""
    return 128 if bm % 128 == 0 else 64


def dgrad_plan(w1, w3, w2, toks, dy, n_tiles: int, route=None):
    """``(T, D, F, E, bm, tma, rows)`` of a K1 call, from shapes and
    pointers alone (no launch, no card): ``tma`` from :func:`pick_route`
    over the operands, ``rows`` the TMA route's row block
    (:func:`bwd_rows`; 64, the general route's, otherwise). Raises
    ValueError on shapes the kernels do not take."""
    T, D = toks.shape
    E, _, F = w1.shape
    if w3.shape != (E, D, F) or w2.shape != (E, F, D) or w1.shape[1] != D \
            or dy.shape != (T, D):
        raise ValueError(f"ragged_moe_ffn_dgrad: shapes w1 {tuple(w1.shape)}"
                         f", w3 {tuple(w3.shape)}, w2 {tuple(w2.shape)}, "
                         f"toks {tuple(toks.shape)}, dy {tuple(dy.shape)}")
    if n_tiles == 0 or T % n_tiles or (T // n_tiles) % ROW_BLOCK:
        raise ValueError(f"ragged_moe_ffn_dgrad: T={T} over {n_tiles} tiles "
                         f"is not a row tile that is a multiple of "
                         f"{ROW_BLOCK}")
    bm = T // n_tiles
    tma = pick_route("ragged_moe_ffn_dgrad", route, (w1, w3, w2, toks, dy))
    rows = bwd_rows(bm) if tma else ROW_BLOCK
    return T, D, F, E, bm, tma, rows


def wgrad_plan(toks, h, da, db, dy, route=None):
    """``(T, D, F, tma)`` of a K2 call, from shapes and pointers alone:
    ``tma`` from :func:`pick_route` over the operands. Raises ValueError on
    shapes the kernels do not take."""
    T, D = toks.shape
    F = h.shape[1]
    if h.shape != (T, F) or da.shape != (T, F) or db.shape != (T, F) \
            or dy.shape != (T, D):
        raise ValueError("ragged_moe_ffn_wgrad: h, da, db must be (T, F) "
                         "and dy (T, D) beside toks (T, D)")
    tma = pick_route("ragged_moe_ffn_wgrad", route, (toks, h, da, db, dy))
    return T, D, F, tma


def dgrad_outputs(w1, w3, w2, toks, tile_group, row_offsets, sizes, dy,
                  kind: str = "cuda", route=None):
    """K1's checks and allocations on a device of type ``kind`` (``meta``
    for a traced call): ``((dx (T, D), da (T, F), db (T, F)), plan)``,
    uninitialised, the plan :func:`dgrad_plan`'s; reports the call's
    entry (``10 T D F``: gate/up again, ``dy W2ᵀ``, ``da W1ᵀ + db W3ᵀ``)."""
    check_operands("ragged_moe_ffn_dgrad", {"w1": w1, "w3": w3, "w2": w2,
                                            "toks": toks, "dy": dy}, kind)
    n_tiles = tile_group.shape[0]
    plan = dgrad_plan(w1, w3, w2, toks, dy, n_tiles, route)
    T, D, F, E = plan[:4]
    dev = toks.device
    _check_index("tile_group", tile_group, n_tiles, dev)
    _check_index("row_offsets", row_offsets, E + 1, dev)
    _check_index("sizes", sizes, E, dev)
    dx = torch.empty_like(toks)
    da = torch.empty((T, F), dtype=toks.dtype, device=dev)
    db = torch.empty_like(da)
    costs.report("ragged_moe_ffn_dgrad", 10.0 * T * D * F, costs.tensor_bytes(
        w1, w3, w2, toks, tile_group, row_offsets, sizes, dy, dx, da, db))
    return (dx, da, db), plan


def wgrad_outputs(toks, h, da, db, dy, row_offsets, sizes,
                  kind: str = "cuda", route=None):
    """K2's checks and allocations on a device of type ``kind``:
    ``((dw1, dw3 (E, D, F), dw2 (E, F, D)), (T, D, F, E, tma))``,
    uninitialised; reports the call's entry (``6 T D F``)."""
    check_operands("ragged_moe_ffn_wgrad", {"toks": toks, "h": h, "da": da,
                                            "db": db, "dy": dy}, kind)
    T, D, F, tma = wgrad_plan(toks, h, da, db, dy, route)
    E = sizes.shape[0]
    _check_index("row_offsets", row_offsets, E + 1, toks.device)
    _check_index("sizes", sizes, E, toks.device)
    dw1 = torch.empty((E, D, F), dtype=toks.dtype, device=toks.device)
    dw3 = torch.empty_like(dw1)
    dw2 = torch.empty((E, F, D), dtype=toks.dtype, device=toks.device)
    costs.report("ragged_moe_ffn_wgrad", 6.0 * T * D * F, costs.tensor_bytes(
        toks, h, da, db, dy, row_offsets, sizes, dw1, dw3, dw2))
    return (dw1, dw3, dw2), (T, D, F, E, tma)


def _bwd_lib():
    lib = build.load("ragged_moe_ffn_bwd")
    if lib.ragged_moe_ffn_dgrad_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ragged_moe_ffn_dgrad_bf16.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.ragged_moe_ffn_wgrad_bf16.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.ragged_moe_ffn_dgrad_tma_bf16.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.ragged_moe_ffn_wgrad_tma_bf16.argtypes = [p] * 10 + [i] * 4 + [p]
        for fn in (lib.ragged_moe_ffn_dgrad_bf16,
                   lib.ragged_moe_ffn_wgrad_bf16,
                   lib.ragged_moe_ffn_dgrad_tma_bf16,
                   lib.ragged_moe_ffn_wgrad_tma_bf16):
            fn.restype = ctypes.c_int
    return lib


def ragged_moe_ffn_dgrad(w1, w3, w2, toks, tile_group, row_offsets, sizes,
                         dy, route=None):
    """Launch K1: ``dy (T, D)`` → ``(dx (T, D), da (T, F), db (T, F))``
    bf16, as :func:`~.ref.ragged_moe_ffn_bwd_ref` computes ``dx`` and its
    rounded ``da``, ``db``. Only the plan's real rows are computed; every
    other row of ``dx`` is exactly zero, and ``da``, ``db`` are written on
    real rows only (the rows :func:`ragged_moe_ffn_wgrad` reads).

    Two routes (:func:`pick_route`): the TMA route
    (``csrc/moe_ffn_hopper_bwd.cuh``; row block :func:`bwd_rows`) where :func:`tma_ok` holds for every operand,
    the general route (WMMA) otherwise or with ``route="general"``
    (:func:`dgrad_plan` makes the choice without a card). Raises
    on what the kernel does not take and if the launch is refused. Adds
    one to ``ragged_moe_ffn_dgrad.launches`` and, on the TMA route, to
    ``ragged_moe_ffn_dgrad.tma_launches``."""
    (dx, da, db), (T, D, F, E, bm, tma, rows) = dgrad_outputs(
        w1, w3, w2, toks, tile_group, row_offsets, sizes, dy, route=route)
    lib = _bwd_lib()
    args = [toks.data_ptr(), dy.data_ptr(), tile_group.data_ptr(),
            row_offsets.data_ptr(), sizes.data_ptr(), w1.data_ptr(),
            w3.data_ptr(), w2.data_ptr(), da.data_ptr(), db.data_ptr(),
            dx.data_ptr(), T, D, F, E, bm]
    stream = torch._C._cuda_getCurrentRawStream(toks.get_device())
    if tma:
        err = lib.ragged_moe_ffn_dgrad_tma_bf16(*args, rows, stream)
    else:
        err = lib.ragged_moe_ffn_dgrad_bf16(*args, stream)
    if err != 0:
        raise RuntimeError(f"ragged_moe_ffn_dgrad: CUDA launch failed with "
                           f"cudaError {err}")
    ragged_moe_ffn_dgrad.launches += 1
    ragged_moe_ffn_dgrad.tma_launches += tma
    ragged_moe_ffn_dgrad.last_route = f"tma rows={rows}" if tma \
        else "general"
    return dx, da, db


ragged_moe_ffn_dgrad.launches = 0
ragged_moe_ffn_dgrad.tma_launches = 0
ragged_moe_ffn_dgrad.last_route = None


def ragged_moe_ffn_wgrad(toks, h, da, db, dy, row_offsets, sizes,
                         route=None):
    """Launch K2: ``(dw1 (E, D, F), dw3 (E, D, F), dw2 (E, F, D))`` bf16 =
    ``xᵀ da``, ``xᵀ db``, ``hᵀ dy`` over each expert's real rows, summed
    in f32 in a fixed order; an expert with no rows gets zeros. Rows past
    an expert's real ones are never read into a sum, whatever they hold.

    Two routes, as :func:`ragged_moe_ffn_dgrad`'s (the TMA route's CTA
    computes a 128 x 64 tile of dW). Raises on what
    the kernel does not take and if the launch is refused. Adds one to
    ``ragged_moe_ffn_wgrad.launches`` and, on the TMA route, to
    ``ragged_moe_ffn_wgrad.tma_launches``."""
    (dw1, dw3, dw2), (T, D, F, E, tma) = wgrad_outputs(
        toks, h, da, db, dy, row_offsets, sizes, route=route)
    lib = _bwd_lib()
    args = [toks.data_ptr(), h.data_ptr(), da.data_ptr(), db.data_ptr(),
            dy.data_ptr(), row_offsets.data_ptr(), sizes.data_ptr(),
            dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(), T, D, F, E]
    stream = torch._C._cuda_getCurrentRawStream(toks.get_device())
    if tma:
        err = lib.ragged_moe_ffn_wgrad_tma_bf16(*args, stream)
    else:
        err = lib.ragged_moe_ffn_wgrad_bf16(*args, stream)
    if err != 0:
        raise RuntimeError(f"ragged_moe_ffn_wgrad: CUDA launch failed with "
                           f"cudaError {err}")
    ragged_moe_ffn_wgrad.launches += 1
    ragged_moe_ffn_wgrad.tma_launches += tma
    ragged_moe_ffn_wgrad.last_route = "tma" if tma else "general"
    return dw1, dw3, dw2


ragged_moe_ffn_wgrad.launches = 0
ragged_moe_ffn_wgrad.tma_launches = 0
ragged_moe_ffn_wgrad.last_route = None
