"""Chunked attention on Hopper: the prefill forward and the decode step.

Replaces no Pallas kernel: the reference computes attention in plain jnp
(``flash_attention``, ``src/repro/models/flash.py:45``, and
``flash_decode``, ``:133``), whose plain PyTorch versions are
:mod:`repro_torch.models.flash`. Hand-written CUDA C++ kernels of
``csrc/flash_attention.cu`` take their place on the card:

* :func:`flash_attn_fwd` — the online softmax over key tiles of a fixed
  length from key row 0, for every prefill call site (whole prompt,
  context mode, a chunk against a lane of the cache under ``kv_valid``).
  A block holds rows of one (lane, KV head): the query positions and the
  G query heads of that KV head, flattened. Two routes, chosen by
  :func:`route_of` from the dtype, each with a kernel for every head size
  of :data:`HEAD_DIMS`. The Hopper route, bf16: 128-row blocks, K and V
  tiles by TMA, two consumer warpgroups on ``wgmma``; beside a producer
  warpgroup with 128-key tiles at hd 32, 64, 80 and 128 (hd 32 and 80 in a
  partial 64-value panel, the columns past hd read as zeros and never
  multiplied), at hd 256 with no producer warp, the block staging its own
  64-key tiles, so that O's 128 registers a thread fit. At hd 32 the
  exponentials bound it (a pair's ``ex2`` outlasts its products): the two
  warpgroups take turns at the tensor cores so that one's softmax runs
  under the other's products. The tf32x3 route, f32: each f32 product as
  three TF32 products on the tensor cores; at hd 32, 64 and 80 ``wgmma``
  for the scores from Q's and K's split parts in shared memory and
  ``mma.sync`` for P V; at hd 128 and 256, where those parts would not
  fit, every product on ``mma.sync`` with each operand split in registers
  as it is read from one raw copy. A key tile whose mask is
  provably false for every row of the block (from the tile's and the
  block's position bounds, never from an assumption that positions are
  sorted) is skipped: for a row with a valid key that is exactly what
  computing it gives (p = 0, the correction 1), and a row with no valid
  key at all takes the plain version's value, the sum of ``v`` over the
  keys divided by the padded key count
  (:func:`~repro_torch.models.flash.padded_keys`), in a pass of its own.
  Bound: at long context the tensor cores (4 · Sq · Skv · H · hd FLOPs,
  halved by causal skipping).
* :func:`flash_attn_bwd` — the prefill's backward on the card, hand-written
  kernels of ``csrc/flash_attention_bwd.cu`` (the reference takes this
  gradient by autodiff of its jnp online softmax; the plain version is
  :func:`~repro_torch.models.flash.flash_attention_bwd`), from the
  forward's output and rows' stats: ``flash_attn_bwd_dq`` (a block a row
  block, walking the key tiles the masks leave: dQ, and each row's D =
  dout·out for the second) then ``flash_attn_bwd_dkdv`` (a block a key
  tile, walking the row blocks the masks leave: dK, dV), ``mma.sync`` on
  the tensor cores, bf16 or three TF32 products a product in f32, at
  every (dtype, hd) of the forward's table. No atomics: two calls give the
  same bits. Bound: the tensor cores (10 · Sq · Skv · H · hd FLOPs of
  valid pairs).
* :func:`flash_decode` — one query token a lane against the cache, in one
  launch: a block reads one split of :func:`decode_split_rows` cache rows
  of one (lane, KV head) once for up to 8 of its G query heads, and only
  the rows that can be valid (``<= pos``, within the window), through a
  ``cp.async`` ring; the last block of a (lane, KV head) to finish,
  found by a ticket (a per-device counter, zero between launches), merges
  the splits' softmax stats in split order. The split is a function of
  ``S_max`` alone, so a lane's result never depends on B, its neighbours
  or the SM count. Bound: the bytes of the valid rows.

A row's result depends only on its own q row, its lane's k/v for its head
and the masks: the grid witnesses of ``chip_smoke.py`` split heads, lanes
and query rows and hold the ranks bit for bit against one device.

On a CUDA tensor each wrapper launches its kernel or raises (an
unsupported head size or dtype raises ``ValueError`` naming the shape);
the CPU, gradient and ``meta`` paths live in :mod:`.ops`. The allocation
helpers :func:`attn_outputs`, :func:`attn_bwd_outputs` and
:func:`decode_outputs` do the checks and
allocations of a call on the card or on ``meta`` and report its cost
entry (:mod:`.costs`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build, costs
from .route_select import _zeros_at_least

__all__ = ["flash_attn_fwd", "flash_attn_bwd", "flash_decode",
           "attn_outputs", "attn_bwd_outputs", "bwd_rows", "decode_outputs",
           "decode_splits", "decode_split_rows", "route_of", "HEAD_DIMS"]

#: head sizes the kernels are compiled for: every size a path on the card
#: runs (jamba and granite smoke 32, granite and smollm 64, hubert 80,
#: pixtral, qwen3 and most others 128, gemma3 256), on both prefill routes
HEAD_DIMS = (32, 64, 80, 128, 256)
#: the C entry points' dtype codes; the prefill's route follows the dtype
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ROUTES = {torch.bfloat16: "tma", torch.float32: "tf32x3"}
_POS = (torch.int32, torch.int64)

#: per device: the decode's tickets (a (lane, KV head, head group)'s splits
#: done; zero between launches), used only inside a launch, so launches in
#: one stream share them (the port runs on one stream)
_TICKETS: Dict[int, torch.Tensor] = {}


def _lib():
    lib = build.load("flash_attention")
    if lib.flash_attn_fwd.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.flash_attn_fwd.argtypes = (
            [p, p, p, p, p, p, p, i, p, i, p] + [i] * 6 + [ll] * 10
            + [i, i, f, f, i, p])
        lib.flash_decode.argtypes = (
            [p, p, p, p, i, p, p, p, p, p, p, p] + [i] * 7 + [ll] * 9
            + [i, ll, f, i, i, p])
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_decode.restype = ctypes.c_int
    return lib


def route_of(dtype: torch.dtype, hd: int) -> str:
    """The prefill kernel's route for q of ``dtype`` and head size ``hd``:
    ``"tma"`` (the Hopper route: TMA and ``wgmma``) for bf16,
    ``"tf32x3"`` (three TF32 products on the tensor cores) for f32, at
    every hd in :data:`HEAD_DIMS`; a pair outside the table raises
    ``ValueError``. A function of (dtype, hd) alone, so a chunk and the
    whole prompt, a rank and one device take the same route."""
    if dtype not in _ROUTES or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd: no route for {dtype} at hd {hd}")
    return _ROUTES[dtype]


def _check(kernel, kind, q, *others):
    """q on a device of type ``kind`` with a head size and dtype the
    kernel takes; every other tensor (name, tensor) on q's device in q's
    dtype. Plain comparisons: a decode step calls this once a layer."""
    dt, dev = q.dtype, q.device
    if dev.type != kind:
        where = "CUDA" if kind == "cuda" else kind
        raise ValueError(f"{kernel}: q is not on a {where} device")
    if dt not in _DTYPES or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{kernel}: q {tuple(q.shape)} {dt}: the kernel "
                         f"takes hd in {HEAD_DIMS} in bfloat16 or float32")
    for name, t in others:
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, q {dt} on {dev}")


def _check_rows(kernel, *tensors):
    """The kernels read rows of hd values with 16-byte loads: each row
    contiguous, every other stride and the start 16-byte aligned."""
    for name, t in tensors:
        size = t.element_size()
        st = t.stride()
        if st[-1] != 1 or t.data_ptr() % 16 or any(
                x * size % 16 for x in st[:-1]):
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} strides "
                             f"{st}: rows must be contiguous and 16-byte "
                             "aligned")


def _check_vec(kernel, name, t, n, dtypes, dev):
    if t is None:
        return
    if t.device != dev or t.dtype not in dtypes or t.shape != (n,) or (
            n > 1 and t.stride(0) != 1):
        raise ValueError(f"{kernel}: {name} {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}: wants ({n},) {dtypes} on {dev}")


def _check_prefill(name, kind, q, k, v, q_positions, kv_positions,
                   kv_valid):
    """The prefill's shapes, dtypes, devices and grid limits (forward and
    backward alike): raises on what the kernels do not take, returns q's
    (B, Sq, KV, G, hd)."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: wants (B, Sq, KV, G, hd) and "
                         "(B, Skv, KV, hd)")
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, KV, hd) or 0 in (
            B, Sq, Skv, KV, G):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit")
    _check(name, kind, q, ("k", k), ("v", v))
    _check_vec(name, "q_positions", q_positions, Sq, _POS, q.device)
    _check_vec(name, "kv_positions", kv_positions, Skv, _POS, q.device)
    _check_vec(name, "kv_valid", kv_valid, Skv, (torch.bool,), q.device)
    if B > 65535 or KV > 65535:
        raise ValueError(f"{name}: B {B}, KV {KV} past the grid's 65535")
    return B, Sq, KV, G, hd


def attn_outputs(q, k, v, q_positions=None, kv_positions=None,
                 kv_valid=None, kind: str = "cuda", stats: bool = False):
    """The prefill call's checks and allocation on a device of type
    ``kind`` (``meta`` for a traced call): raises on what the kernel does
    not take, returns ``out`` (B, Sq, KV, G, hd) in q's dtype,
    uninitialised (with ``stats`` also the rows' f32 ``m`` and ``l``, each
    (B, KV, G, Sq)), and reports the call's entry: the two Sq x Skv
    products the plain version computes (``4 B KV G Sq Skv hd``
    operations) and the bytes of q, k, v, the positions, the mask and the
    outputs."""
    name = "flash_attn_fwd"
    B, Sq, KV, G, hd = _check_prefill(name, kind, q, k, v, q_positions,
                                      kv_positions, kv_valid)
    Skv = k.shape[1]
    outs = (torch.empty(q.shape, dtype=q.dtype, device=q.device),)
    if stats:
        outs += tuple(torch.empty((B, KV, G, Sq), dtype=torch.float32,
                                  device=q.device) for _ in range(2))
    if costs.listening():
        costs.report(name, 4.0 * B * KV * G * Sq * Skv * hd,
                     costs.tensor_bytes(q, k, v, q_positions, kv_positions,
                                        kv_valid, *outs))
    return outs if stats else outs[0]


def flash_attn_fwd(q, k, v, *, causal=True, window=None, q_positions=None,
                   kv_positions=None, kv_valid=None,
                   return_stats: bool = False):
    """Launch the prefill kernel: ``flash_attention``'s forward over the
    GQA layout (q (B, Sq, KV, G, hd); k, v (B, Skv, KV, hd), rows
    contiguous and 16-byte aligned, any strides above) → (B, Sq, KV, G,
    hd) in q's dtype, or with ``return_stats`` ``(out, m, l)``, the rows'
    softmax stats of :func:`repro_torch.models.flash.flash_attention`.
    ``window``: a Python int, 0 or None for full. The route is
    :func:`route_of`'s. Adds one to ``flash_attn_fwd.launches`` and to
    the route's own count (``flash_attn_fwd.tma_launches`` on the Hopper
    route, ``flash_attn_fwd.tf32x3_launches`` on the tf32x3 route), so
    that the two always add up to the total; raises if the launch is
    refused."""
    outs = attn_outputs(q, k, v, q_positions, kv_positions, kv_valid,
                        stats=return_stats)
    out, m, l = outs if return_stats else (outs, None, None)
    _check_rows("flash_attn_fwd", ("q", q), ("k", k), ("v", v))
    from ..models.flash import _scale, padded_keys
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]

    def ptr(t):
        return None if t is None else t.data_ptr()

    def wide(t):
        return int(t is not None and t.dtype == torch.int64)

    taken = route_of(q.dtype, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(m),
        ptr(l), ptr(q_positions), wide(q_positions), ptr(kv_positions),
        wide(kv_positions), ptr(kv_valid), B, Sq, Skv, KV, G, hd,
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
        int(causal), 0 if window is None else int(window), _scale(hd),
        float(padded_keys(Skv)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd: CUDA launch failed with "
                           f"cudaError {err}")
    flash_attn_fwd.launches += 1
    flash_attn_fwd.tma_launches += taken == "tma"
    flash_attn_fwd.tf32x3_launches += taken == "tf32x3"
    return outs


flash_attn_fwd.launches = 0
flash_attn_fwd.tma_launches = 0
flash_attn_fwd.tf32x3_launches = 0


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    for fn in (lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkdv):
        if fn.argtypes is None:
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = ([p] * 8 + [i, p, i] + [p] * 7 + [i] * 7 + [p]
                           + [i, i, f, i, p])
            fn.restype = ctypes.c_int
    return lib


def bwd_rows(dtype: torch.dtype, hd: int) -> int:
    """Rows a row block of the backward's kernels (both take the same
    blocks; ``BwdCfg::BM`` of ``csrc/flash_attention_bwd.cu``, which the
    launch checks): 64, or 32 in f32 at hd 128 and 256, where the f32
    operands of 64 rows would not fit in shared memory beside the key
    tile."""
    route_of(dtype, hd)
    return 32 if dtype == torch.float32 and hd >= 128 else 64


def attn_bwd_outputs(q, k, v, out, dout, m, l, q_positions=None,
                     kv_positions=None, kv_valid=None, kind: str = "cuda"):
    """The backward call's checks and allocations on a device of type
    ``kind``: raises on what the kernels do not take; returns ``((dq, dk,
    dv), scratch)``, the gradients in their inputs' shapes and dtypes and
    the scratch the dQ kernel writes for the dK/dV kernel — each row's f32
    D = dout.out (B, KV, Sq G), each row block's f32 sum of dout / l over
    its rows with no valid key (B, KV, n, hd) and its int64 query-position
    bounds and flag (B, KV, n, 3), n row blocks of :func:`bwd_rows` — all
    uninitialised; reports one entry a kernel. The five products of the
    plain backward over every pair (``10 B KV G Sq Skv hd``) split between
    them as the dQ kernel's three (the scores again, dP, dQ) and the dK/dV
    kernel's two new ones (dV, dK; its scores and dP again are not
    counted a second time), so the dry run's FLOPs are the plain
    backward's; the bytes: each kernel's inputs read once and its outputs
    and scratch written once (the scratch read back once by the second)."""
    name = "flash_attn_bwd"
    B, Sq, KV, G, hd = _check_prefill(name, kind, q, k, v, q_positions,
                                      kv_positions, kv_valid)
    Skv = k.shape[1]
    _check(name, kind, q, ("out", out), ("dout", dout))
    for what, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
    for what, t in (("m", m), ("l", l)):
        if (t.shape != (B, KV, G, Sq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: wants ({B}, {KV}, {G}, {Sq}) "
                             f"float32 contiguous on {q.device}")
    n = -(-Sq * G // bwd_rows(q.dtype, hd))
    grads = (torch.empty(q.shape, dtype=q.dtype, device=q.device),
             torch.empty(k.shape, dtype=k.dtype, device=q.device),
             torch.empty(v.shape, dtype=v.dtype, device=q.device))
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = (torch.empty((B, KV, Sq * G), **f32),
               torch.empty((B, KV, n, hd), **f32),
               torch.empty((B, KV, n, 3), dtype=torch.int64,
                           device=q.device))
    if costs.listening():
        pairs = float(B * KV * G * Sq * Skv * hd)
        ins = costs.tensor_bytes(q, k, v, dout, m, l, q_positions,
                                 kv_positions, kv_valid)
        made = costs.tensor_bytes(*scratch)
        costs.report("flash_attn_bwd_dq", 6.0 * pairs,
                     ins + costs.tensor_bytes(out, grads[0]) + made)
        costs.report("flash_attn_bwd_dkdv", 4.0 * pairs,
                     ins + made + costs.tensor_bytes(*grads[1:]))
    return grads, scratch


def flash_attn_bwd(q, k, v, out, dout, m, l, *, causal=True, window=None,
                   q_positions=None, kv_positions=None, kv_valid=None):
    """Launch the backward's two kernels: the gradients ``(dq, dk, dv)``
    of :func:`flash_attn_fwd` from its output ``out``, the gradient
    ``dout`` and the rows' stats ``(m, l)`` that ``return_stats`` gave
    (:func:`repro_torch.models.flash.flash_attention_bwd`'s function),
    each in its input's dtype. q, k, v, out and dout: rows contiguous and
    16-byte aligned, any strides above; m, l contiguous. The dQ kernel
    first (``flash_attn_bwd_dq``: it also writes the scratch), then the
    dK/dV kernel (``flash_attn_bwd_dkdv``), on the route
    :func:`route_of` names for (dtype, hd), each counted as the forward
    is (``flash_attn_bwd_dq.launches`` and its route's
    ``.tma_launches`` / ``.tf32x3_launches``; the same of
    ``flash_attn_bwd_dkdv``); raises if a launch is refused."""
    (dq, dk, dv), scratch = attn_bwd_outputs(
        q, k, v, out, dout, m, l, q_positions, kv_positions, kv_valid)
    _check_rows("flash_attn_bwd", ("q", q), ("k", k), ("v", v),
                ("out", out), ("dout", dout))
    from ..models.flash import _scale
    B, Sq, KV, G, hd = q.shape
    taken = route_of(q.dtype, hd)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def wide(t):
        return int(t is not None and t.dtype == torch.int64)

    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:4], *dout.stride()[:4])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), m.data_ptr(), l.data_ptr(), ptr(q_positions),
            wide(q_positions), ptr(kv_positions), wide(kv_positions),
            ptr(kv_valid), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(t.data_ptr() for t in scratch), B, Sq, k.shape[1], KV, G, hd,
            bwd_rows(q.dtype, hd), strides, int(causal),
            0 if window is None else int(window), _scale(hd),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    flash_attn_bwd_dq(args, taken)
    flash_attn_bwd_dkdv(args, taken)
    return dq, dk, dv


def _launch_bwd(kernel, args, taken: str) -> None:
    """Launch the backward's ``kernel`` (its entry point of the same name)
    on :func:`flash_attn_bwd`'s packed arguments and count it as
    :func:`flash_attn_fwd` counts its launches: one to ``kernel.launches``
    and one to the count of the route ``taken``, :func:`route_of`'s name
    for (dtype, hd) — ``kernel.tma_launches`` for bf16 (the name is the
    forward's bf16 route's, whose kernels load through TMA; the
    backward's load through ``cp.async``), ``kernel.tf32x3_launches`` for
    f32 — so that the two always add up to the total."""
    name = kernel.__name__
    err = getattr(_bwd_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    kernel.launches += 1
    kernel.tma_launches += taken == "tma"
    kernel.tf32x3_launches += taken == "tf32x3"


def flash_attn_bwd_dq(args, taken: str) -> None:
    """Launch the backward's dQ kernel (dq, and the scratch the dK/dV
    kernel reads) on :func:`flash_attn_bwd`'s packed arguments."""
    _launch_bwd(flash_attn_bwd_dq, args, taken)


def flash_attn_bwd_dkdv(args, taken: str) -> None:
    """Launch the backward's dK/dV kernel on :func:`flash_attn_bwd`'s
    packed arguments, after :func:`flash_attn_bwd_dq`."""
    _launch_bwd(flash_attn_bwd_dkdv, args, taken)


for _kernel in (flash_attn_bwd_dq, flash_attn_bwd_dkdv):
    _kernel.launches = _kernel.tma_launches = _kernel.tf32x3_launches = 0


def decode_split_rows(S_max: int) -> int:
    """Cache rows a decode block reads (the kernel's ``split_rows``), a
    function of ``S_max`` alone: 256 up to 8192 rows, so that a short
    cache still gives the card several blocks a (lane, KV head); then
    doubling up to 1024, so that a cache of up to 32768 rows takes at most
    32 splits to merge."""
    rows = 256
    while rows < 1024 and rows * 32 < S_max:
        rows *= 2
    return rows


def decode_splits(S_max: int) -> int:
    """Splits of the cache a decode call reads: ``ceil(S_max /
    decode_split_rows(S_max))``, a function of ``S_max`` alone."""
    return -(-S_max // decode_split_rows(S_max))


def decode_outputs(q, k_cache, v_cache, pos, return_stats=False,
                   kind: str = "cuda"):
    """The decode call's checks and allocations on a device of type
    ``kind``: returns ``(outputs, scratch)`` — ``outputs`` the normalised
    (B, KV, G, hd) in q's dtype, or with ``return_stats`` the f32 ``(acc
    (B, KV, G, hd), m (B, KV, G), l (B, KV, G))``; ``scratch`` None, or
    for more than one split the splits' f32 partials ``(acc (B, KV, n, G,
    hd), ml (B, KV, n, G, 2))`` that the last block of a (lane, KV head)
    reads to merge them — and reports the
    entry: the two products over every cache row (``4 B KV G S_max hd``)
    and the bytes of q, the caches, ``pos`` and the outputs, the scratch
    written once and read back once."""
    name = "flash_decode"
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}: "
                         "wants (B, KV, G, hd) and (B, S_max, KV, hd)")
    B, KV, G, hd = q.shape
    S_max = k_cache.shape[1]
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (
            B, KV, hd) or 0 in (B, S_max, KV, G):
        raise ValueError(f"{name}: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} do not fit")
    _check(name, kind, q, ("k_cache", k_cache), ("v_cache", v_cache))
    _check_vec(name, "pos", pos, B, _POS, q.device)
    if B > 65535 or KV * -(-G // 8) > 65535 or decode_splits(S_max) > 65535:
        raise ValueError(f"{name}: B {B}, KV {KV}, G {G}, S_max {S_max} "
                         "past the grid")
    f32 = dict(dtype=torch.float32, device=q.device)
    if return_stats:
        outs = (torch.empty((B, KV, G, hd), **f32),
                torch.empty((B, KV, G), **f32),
                torch.empty((B, KV, G), **f32))
    else:
        outs = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    n = decode_splits(S_max)
    scratch = None
    if n > 1:
        scratch = (torch.empty((B, KV, n, G, hd), **f32),
                   torch.empty((B, KV, n, G, 2), **f32))
    if costs.listening():
        costs.report(name, 4.0 * B * KV * G * S_max * hd,
                     costs.tensor_bytes(q, k_cache, v_cache, pos,
                                        *(outs if return_stats
                                          else (outs,)))
                     + 2 * costs.tensor_bytes(*(scratch or ())))
    return outs, scratch


def flash_decode(q, k_cache, v_cache, pos, *, window=None, kpos_offset=0,
                 return_stats=False):
    """Launch the decode kernel: q (B, KV, G, hd) against caches (B, S_max,
    KV, hd) (rows contiguous and 16-byte aligned), ``pos`` (B,) int32 or
    int64, cache row 0 at global position ``kpos_offset`` → (B, KV, G, hd)
    in q's dtype, or with ``return_stats`` the f32 ``(acc, m, l)`` of
    :func:`repro_torch.models.flash.flash_decode` (a cache with no valid
    row of a lane: ``m = _NEG``, ``l = 0``, ``acc = 0``). One launch, its
    splits merged inside it in split order. Adds one to
    ``flash_decode.launches``; raises if the launch is refused."""
    outs, scratch = decode_outputs(q, k_cache, v_cache, pos, return_stats)
    _check_rows("flash_decode", ("q", q), ("k_cache", k_cache),
                ("v_cache", v_cache))
    from ..models.flash import _scale
    B, KV, G, hd = q.shape
    S_max = k_cache.shape[1]
    if return_stats:
        acc, m, l = outs
        o_ptrs = (None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        o_ptrs = (outs.data_ptr(), None, None, None)
    s_ptrs = (None, None) if scratch is None else tuple(
        t.data_ptr() for t in scratch)
    tickets = _zeros_at_least(_TICKETS, q.get_device(), B * KV * -(-G // 8),
                              q.device).data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        int(pos.dtype == torch.int64), *o_ptrs, *s_ptrs, tickets, B, S_max,
        KV, G, hd, decode_splits(S_max), decode_split_rows(S_max),
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        0 if window is None else int(window), int(kpos_offset), _scale(hd),
        int(return_stats), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: CUDA launch failed with "
                           f"cudaError {err}")
    flash_decode.launches += 1
    return outs


flash_decode.launches = 0
