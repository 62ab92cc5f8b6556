"""Fused MoE routing on Hopper: one CUDA launch routes one layer.

Replaces the TPU kernel ``repro.kernels.router.router_topk_pallas``
(``src/repro/kernels/router.py:47``) and the tensor ops the reference's
routing stage runs around it (``repro.models.moe``: ``route``,
``_select_slots``, ``_masked_tally``, ``_aux_loss``) with the hand-written
CUDA C++ kernel in ``csrc/route_select.cu``: the f32 router product,
softmax, top-k with renormalisation, replica selection, the masked tally,
the mean probabilities and the load-balance aux loss, from the layer's
bf16 activations, in one launch. :func:`router_topk` is the TPU kernel's
own function (logits in, top-k out) through the same epilogue.

:func:`plan` picks the launch's shape from static sizes: row blocks of
``TR`` rows and, where they are too few to fill the card (decode), a split
of D into ``S`` ranges whose partial logits the last block of each row
block sums in a fixed order. The tickets that find that block, and the
scratch of partial sums, live in per-device buffers kept here; the kernel
resets each ticket after it is consumed.

For training, ``route_select(..., with_probs=True)`` also returns the
softmax ``p (T, E)`` that the kernel writes beside its outputs, with the
gate weights in an f32 allocation of their own, and
:func:`route_select_bwd` launches the stage's backward to its logits (a
third entry of the same source).

On a CUDA tensor each wrapper launches or raises; the CPU path lives in
:mod:`.ops`, which sends CPU tensors to the plain versions (:mod:`.ref`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import build, costs

__all__ = ["route_select", "route_select_bwd", "router_topk", "plan",
           "route_outputs", "route_bwd_outputs", "topk_outputs"]

#: threads a block (``THREADS`` in ``csrc/route_select.cu``)
THREADS = 256
#: blocks to aim for: two a streaming multiprocessor on the H100's 132
TARGET_BLOCKS = 264
#: most ranges D is split into (more makes the final sum longer)
MAX_SPLIT = 16

#: per device: the ticket counters (zero between launches) and the
#: scratch of partial sums, both used only inside a launch, so launches in
#: one stream share them (the port runs on one stream)
_TICKETS: Dict[int, torch.Tensor] = {}
_SCRATCH: Dict[int, torch.Tensor] = {}


#: the fused launch's 23 arguments, packed for one ctypes call with one
#: pointer (the C entry reads them before it returns)
_ARGS = (ctypes.c_int64 * 23)()
_ARGS_PTR = ctypes.addressof(_ARGS)


def _lib():
    lib = build.load("route_select")
    if lib.route_select_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.route_select_bf16.argtypes = [p]
        lib.route_select_bf16.restype = ctypes.c_int
        lib.router_topk_f32.argtypes = [p, p, p, i, i, i, p]
        lib.router_topk_f32.restype = ctypes.c_int
        lib.route_select_bwd_f32.argtypes = [p] * 9 + [i, i, i, p]
        lib.route_select_bwd_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def plan(T: int, D: int, E: int):
    """``(TR, DC, S, cps, n_rb)`` of a launch: rows a block (a multiple of
    4, at most 32 and as many as 256 threads of 4 x 4 outputs hold: the
    block's last finisher runs the softmax and top-k of its rows, 4 a warp,
    so small row blocks spread that tail over more SMs), the depth of a
    staged chunk, the number of D ranges, chunks a range, row blocks. S is
    chosen for about ``TARGET_BLOCKS`` blocks in all, so at decode (one row
    block) S blocks read the router's weights together."""
    ncg = -(-E // 4)
    nrg = max(1, min(THREADS // ncg, 8, -(-T // 4)))
    tr = 4 * nrg
    n_rb = -(-T // tr)
    dc = 32 if E <= 128 else 16 if E <= 512 else 8
    n_chunks = -(-D // dc)
    split = max(1, min(-(-TARGET_BLOCKS // n_rb), n_chunks, MAX_SPLIT))
    cps = -(-n_chunks // split)
    split = -(-n_chunks // cps)
    return tr, dc, split, cps, n_rb


def _zeros_at_least(cache: Dict[int, torch.Tensor], index: int, n: int,
                    device) -> torch.Tensor:
    """The device's cached int32 buffer of at least ``n`` words, zeroed
    when it is made (grown to the next power of two)."""
    t = cache.get(index)
    if t is None or t.numel() < n:
        t = torch.zeros(1 << max(n - 1, 1023).bit_length(),
                        dtype=torch.int32, device=device)
        cache[index] = t
    return t


def _bad(t, dtype, shape, index) -> bool:
    return not (isinstance(t, torch.Tensor) and t.dtype is dtype
                and t.shape == shape and t.get_device() == index
                and t.is_contiguous())


def _refuse(specs, index):
    """Raise for the first of ``specs`` (name, tensor, dtype, shape) the
    kernel does not take."""
    for name, t, dtype, shape in specs:
        if not isinstance(t, torch.Tensor) or t.get_device() != index:
            raise ValueError(f"route_select: {name} is not a tensor on "
                             f"cuda:{index}")
        if _bad(t, dtype, shape, index):
            raise TypeError(
                f"route_select: {name} must be a contiguous {dtype} tensor "
                f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def route_outputs(x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                  top_k: int, row_valid=None, with_probs: bool = False,
                  kind: str = "cuda"):
    """The fused launch's checks and allocations on a device of type
    ``kind`` (``meta`` for a traced call): raises on what the kernel does
    not take; returns ``(out, packed, stats, probs)``, ``out`` the
    outputs of :func:`route_select` as views of ``packed`` and ``stats``
    (with ``with_probs`` the weights and ``probs`` allocations of their
    own), uninitialised but at ``T = 0``, where they hold what the plain
    version gives and no launch follows. A call with rows reports its
    entry (:mod:`.costs`: the router product's ``2 T D E``)."""
    where = "CUDA" if kind == "cuda" else kind
    if not isinstance(x, torch.Tensor) or x.device.type != kind:
        raise ValueError(f"route_select: x is not on a {where} device")
    if x.dim() != 2 or router_w.dim() != 2 or slots_of.dim() != 2:
        raise ValueError(f"route_select: x {tuple(x.shape)}, router_w "
                         f"{tuple(router_w.shape)} and slots_of "
                         f"{tuple(slots_of.shape)} must be 2-d")
    T, D = x.shape
    E = router_w.shape[1]
    R = slots_of.shape[1]
    index = x.get_device()
    specs = (("x", x, torch.bfloat16, (T, D)),
             ("router_w", router_w, torch.float32, (D, E)),
             ("slots_of", slots_of, torch.int32, (E, R)),
             ("n_copies", n_copies, torch.int32, (E,)),
             ("copy_cdf", copy_cdf, torch.float32, (E, R)))
    if any(_bad(t, dtype, shape, index) for _, t, dtype, shape in specs):
        _refuse(specs, index)
    if not isinstance(route_seed, torch.Tensor) or route_seed.numel() != 1 \
            or route_seed.dtype is not torch.int32 \
            or route_seed.get_device() != index:
        raise ValueError("route_select: route_seed must be a one-element "
                         f"int32 tensor on {x.device}")
    if row_valid is not None and _bad(row_valid, torch.bool, (T,), index):
        _refuse((("row_valid", row_valid, torch.bool, (T,)),), index)
    if not 1 <= top_k <= min(E, 32) or E > 1024:
        raise ValueError(f"route_select: top_k={top_k} with E={E} (K <= 32, "
                         "E <= 1024)")
    dev = x.device
    packed = torch.empty((3, T, top_k), dtype=torch.int32, device=dev)
    stats = torch.empty((2 * E + 2,), dtype=torch.float32, device=dev)
    w, idx, slots = packed.unbind(0)
    probs = None
    if with_probs:
        w = torch.empty((T, top_k), dtype=torch.float32, device=dev)
        probs = torch.empty((T, E), dtype=torch.float32, device=dev)
    else:
        w = w.view(torch.float32)
    tally, mean_prob, aux = stats.split_with_sizes((E + 1, E, 1))
    aux = aux.view(())
    out = (w, idx, slots, tally, mean_prob, aux)
    if with_probs:
        out = out + (probs,)
    if T == 0:   # what the plain version gives: no rows, mean of nothing
        stats.fill_(float("nan"))
        tally.zero_()
        return out, packed, stats, probs
    costs.report("route_select", 2.0 * T * D * E, costs.tensor_bytes(
        x, router_w, slots_of, n_copies, copy_cdf, route_seed, row_valid,
        packed, stats, probs, w if with_probs else None))
    return out, packed, stats, probs


def route_select(x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                 top_k: int, row_valid=None, with_probs: bool = False):
    """Launch the fused routing kernel.

    ``x (T, D)`` bf16, ``router_w (D, E)`` f32, ``slots_of (E, R)`` int32,
    ``n_copies (E,)`` int32, ``copy_cdf (E, R)`` f32, ``route_seed`` a
    one-element int32 tensor (read on the card), ``row_valid (T,)`` bool or
    None, all contiguous on one CUDA device → ``(weights (T, K) f32,
    idx (T, K) int32, slots (T, K) int32, tally (E + 1,) f32,
    mean_prob (E,) f32, aux () f32)``, as
    :func:`~.ref.route_select_ref`. Raises on what the kernel does not
    take (:func:`route_outputs`, which allocates) and if the launch is
    refused. Adds one to ``route_select.launches``. ``with_probs``
    (training): the kernel also writes the softmax ``p (T, E)`` f32,
    returned seventh, and the weights get an f32 allocation of their own
    rather than a view of the int32 pack.

    The host's part is kept small, since the decode step is host-bound:
    the checks read tensor attributes only, the outputs are views of two
    allocations (weights, idx and slots of one (3, T, K) int32 tensor; the
    tally, mean_prob and aux of one f32 vector), the partial sums and
    tickets live in per-device buffers made once, and the arguments go to
    the C entry packed behind one pointer.
    """
    out, packed, stats, probs = route_outputs(
        x, router_w, slots_of, n_copies, copy_cdf, route_seed, top_k,
        row_valid, with_probs)
    T, D = x.shape
    if T == 0:
        return out
    E = router_w.shape[1]
    R = slots_of.shape[1]
    index = x.get_device()
    dev = x.device
    tr, dc, split, cps, n_rb = plan(T, D, E)
    # scratch words, as the C entry lays them out: partial logits (S > 1),
    # then the row blocks' sums of p and counts (n_rb > 1)
    n_words = (split * T * E if split > 1 else 0) \
        + (2 * n_rb * E if n_rb > 1 else 0)
    _ARGS[:] = (
        x.data_ptr(), router_w.data_ptr(), slots_of.data_ptr(),
        n_copies.data_ptr(), copy_cdf.data_ptr(), route_seed.data_ptr(),
        0 if row_valid is None else row_valid.data_ptr(),
        packed.data_ptr(), stats.data_ptr(),
        _zeros_at_least(_SCRATCH, index, n_words, dev).data_ptr(),
        _zeros_at_least(_TICKETS, index, n_rb + 1, dev).data_ptr(),
        torch._C._cuda_getCurrentRawStream(index),
        T, D, E, top_k, R, tr, dc, cps, split,
        0 if probs is None else probs.data_ptr(),
        out[0].data_ptr() if with_probs else 0)
    err = _lib().route_select_bf16(_ARGS_PTR)
    if err != 0:
        raise RuntimeError(f"route_select: CUDA launch failed with "
                           f"cudaError {err}")
    route_select.launches += 1
    return out


route_select.launches = 0


def route_bwd_outputs(probs, idx, weights, tally, dweights, dmean_prob,
                      daux, row_valid=None, kind: str = "cuda"):
    """The backward launch's checks and its ``dlogits (T, E)`` f32,
    uninitialised, on a device of type ``kind`` (``meta`` for a traced
    call); a call with rows reports its entry (:mod:`.costs`; elementwise,
    so no product's operations)."""
    where = "CUDA" if kind == "cuda" else kind
    if not isinstance(probs, torch.Tensor) or probs.device.type != kind \
            or probs.dim() != 2:
        raise ValueError("route_select_bwd: probs is not a (T, E) tensor on "
                         f"a {where} device")
    T, E = probs.shape
    K = idx.shape[-1]
    index = probs.get_device()
    specs = (("probs", probs, torch.float32, (T, E)),
             ("idx", idx, torch.int32, (T, K)),
             ("weights", weights, torch.float32, (T, K)),
             ("dweights", dweights, torch.float32, (T, K)),
             ("tally", tally, torch.float32, (E,)),
             ("dmean_prob", dmean_prob, torch.float32, (E,)),
             ("daux", daux, torch.float32, ()))
    if row_valid is not None:
        specs += (("row_valid", row_valid, torch.bool, (T,)),)
    if any(_bad(t, dtype, shape, index) for _, t, dtype, shape in specs):
        _refuse(specs, index)
    if not 1 <= K <= min(E, 32) or E > 1024:
        raise ValueError(f"route_select_bwd: top_k={K} with E={E} (K <= 32, "
                         "E <= 1024)")
    dlogits = torch.empty((T, E), dtype=torch.float32, device=probs.device)
    if T:
        costs.report("route_select_bwd", 0.0, costs.tensor_bytes(
            probs, idx, weights, dweights, tally, dmean_prob, daux,
            row_valid, dlogits))
    return dlogits


def route_select_bwd(probs, idx, weights, tally, dweights, dmean_prob, daux,
                     row_valid=None):
    """Launch the routing stage's backward to its logits
    (``route_select_bwd_kernel``): ``probs (T, E)``, ``weights`` and
    ``dweights (T, K)``, the counts ``tally (E,)``, ``dmean_prob (E,)``,
    ``daux
    ()`` f32, ``idx (T, K)`` int32, ``row_valid (T,)`` bool or None, all
    contiguous on one CUDA device → ``dlogits (T, E)`` f32, as
    :func:`~.ref.route_select_dlogits_ref`. Raises on what the kernel
    does not take and if the launch is refused. Adds one to
    ``route_select_bwd.launches``."""
    dlogits = route_bwd_outputs(probs, idx, weights, tally, dweights,
                                dmean_prob, daux, row_valid)
    T, E = probs.shape
    K = idx.shape[-1]
    index = probs.get_device()
    if T == 0:
        return dlogits
    err = _lib().route_select_bwd_f32(
        probs.data_ptr(), idx.data_ptr(), weights.data_ptr(),
        dweights.data_ptr(), tally.data_ptr(), dmean_prob.data_ptr(),
        daux.data_ptr(), None if row_valid is None else row_valid.data_ptr(),
        dlogits.data_ptr(), T, E, K, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"route_select_bwd: CUDA launch failed with "
                           f"cudaError {err}")
    route_select_bwd.launches += 1
    return dlogits


route_select_bwd.launches = 0


def topk_outputs(logits, top_k: int, kind: str = "cuda"):
    """The logits-in launch's checks and its ``(weights, idx)``,
    uninitialised, on a device of type ``kind`` (``meta`` for a traced
    call); a call with rows reports its entry (:mod:`.costs`)."""
    where = "CUDA" if kind == "cuda" else kind
    if not isinstance(logits, torch.Tensor) or logits.device.type != kind:
        raise ValueError(f"router_topk: logits are not on a {where} device")
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or not logits.is_contiguous():
        raise TypeError("router_topk: logits must be a contiguous (T, E) "
                        f"float32 tensor, got {logits.dtype} "
                        f"{tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= top_k <= min(E, 32) or E > 1024:
        raise ValueError(f"router_topk: top_k={top_k} with E={E} (K <= 32, "
                         "E <= 1024)")
    w = torch.empty((T, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    if T:
        costs.report("router_topk", 0.0, costs.tensor_bytes(logits, w, idx))
    return w, idx


def router_topk(logits, top_k: int):
    """Launch the logits-in routing kernel: logits (T, E) f32 contiguous
    CUDA → (weights (T, K) f32, idx (T, K) int32), the TPU kernel's
    function. Raises on what it does not take. Adds one to
    ``router_topk.launches``."""
    w, idx = topk_outputs(logits, top_k)
    T, E = logits.shape
    if T == 0:
        return w, idx
    err = _lib().router_topk_f32(
        logits.data_ptr(), w.data_ptr(), idx.data_ptr(), T, E, top_k,
        torch._C._cuda_getCurrentRawStream(logits.get_device()))
    if err != 0:
        raise RuntimeError(f"router_topk: CUDA launch failed with "
                           f"cudaError {err}")
    router_topk.launches += 1
    return w, idx


router_topk.launches = 0
