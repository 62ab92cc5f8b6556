"""Public kernel entry points: the dispatch between kernel and plain version.

A tensor on the CPU goes to the plain PyTorch version (:mod:`.ref`); a
tensor on a CUDA device goes to the hand-written kernel, which launches or
raises. Nothing here catches a kernel failure to fall back to the plain
version. Each kernel wrapper keeps a plain integer launch count
(``launch_counts``), which only a kernel launch raises.

A tensor on the ``meta`` device (the dry run,
:mod:`repro_torch.launch.dryrun`) goes to the kernel's allocation helper
(``ffn_outputs``, ``dgrad_outputs``, ``wgrad_outputs``, ``fused_outputs``,
``route_outputs``, ``route_bwd_outputs``, ``topk_outputs``), which the
CUDA wrapper calls before it launches: the same checks, the same
allocations and the same cost entry (:mod:`.costs`), and no launch, so no
launch count moves. A traced call allocates what the card allocates, not
the plain version's intermediates. The branches are plain ``if``s on the
device type rather than ``torch.library.custom_op`` with a
``register_fake``: that would add the dispatcher's work to every kernel
call of a decode step that is host-bound already (PERF.md §5).

``ragged_moe_ffn``, ``fused_moe_ffn`` and ``route_select`` are
differentiable on both devices: when an input requires a gradient they go
through an ``autograd.Function`` (:class:`RaggedMoeFFN`,
:class:`FusedMoeFFN`, :class:`RouteSelect`) whose forward is the kernel
and whose backward is a kernel too on the card (``ragged_moe_ffn_dgrad``,
``ragged_moe_ffn_wgrad``, ``moe_ffn_dgrad``, ``moe_ffn_wgrad``,
``route_select_bwd``) and the plain backward on the CPU. When nothing
requires a gradient they call the wrapper directly: the decode step is
host-bound, and serving pays no autograd bookkeeping.

``flash_attention`` and ``flash_decode`` (the hand-written attention
kernels of :mod:`.flash`; their plain versions are
:mod:`repro_torch.models.flash`) take a gradient on the card through
:class:`FlashAttention` and :class:`FlashDecode`, whose forward is the
kernel. The prefill's backward is a kernel too: ``flash_attn_bwd_dq`` then
``flash_attn_bwd_dkdv``, from the forward's output and softmax stats. The
decode's backward (on no trained path) is autograd of the plain version.
On the CPU the plain version's own autograd runs, a checkpoint a key
chunk, as the reference's ``jax.checkpoint``.

``FFN_TILES`` states the tiles of the CUDA FFN kernels' general route,
chosen for Hopper shared memory in place of the v5e VMEM budget the TPU
wrapper sized for (``pick_blocks`` in ``src/repro/kernels/ops.py:24-41``).
The TMA route's tiles and shared-memory plans live in
``csrc/moe_ffn_hopper.cuh`` (``Cfg``) and ``csrc/moe_ffn_hopper_bwd.cuh``
(``DgradCfg``, ``WgradCfg``) alone, which assert at compile time that each
variant fits a block.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import flash as _flash
from . import moe_ffn as _capacity
from . import ragged_moe_ffn as _ragged
from . import ref
from . import route_select as _route

__all__ = ["fused_moe_ffn", "ragged_moe_ffn", "router_topk", "route_select",
           "flash_attention", "flash_decode", "FusedMoeFFN", "RaggedMoeFFN",
           "RouteSelect", "FlashAttention", "FlashDecode", "FFN_TILES",
           "launch_counts", "reset_launch_counts"]

#: (RB, BN, BK) of both FFN kernels' general route
#: (``csrc/moe_ffn_blocks.cuh``, WMMA): RB rows x BN columns per block,
#: BK-deep reduction steps. Static shared memory per block: the x tile
#: RB x (BK + 8) bf16, two weight tiles BK x (BN + 8) bf16 and the f32
#: epilogue tile RB x (BN + 4): 31.7 KB, inside the 48 KB a block may take
#: statically.
FFN_TILES = (_ragged.ROW_BLOCK, 64, 32)


def fused_moe_ffn(w1, w3, w2, toks):
    """Capacity-bucket grouped SwiGLU FFN: toks (E, C, D) → (E, C, D).
    Differentiable in the weights and ``toks``."""
    if _wants_grad(w1, w3, w2, toks):
        return FusedMoeFFN.apply(w1, w3, w2, toks)
    kind = toks.device.type
    if kind == "cpu":
        return ref.moe_ffn_ref(w1, w3, w2, toks)
    if kind == "cuda":
        return _capacity.fused_moe_ffn(w1, w3, w2, toks)
    if kind == "meta":
        return _capacity.fused_outputs(w1, w3, w2, toks, kind)[0]
    raise _no_kernel("fused_moe_ffn", toks.device)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_kernel(name, dev):
    return ValueError(f"{name}: no kernel for device {dev}")


class FusedMoeFFN(torch.autograd.Function):
    """The capacity FFN for autograd. On the card the forward is the
    kernel, keeping its bf16 scratch ``h`` as the saved activation, and
    the backward is the bucket K1 (``dx``, ``da``, ``db``) then K2 (the
    weights' gradients), over every bucket row, on the TMA route (a shape
    it does not take raises); on ``meta`` their allocations and cost
    entries; on the CPU both are the plain versions
    (:func:`~.ref.moe_ffn_bwd_ref`)."""

    @staticmethod
    def forward(ctx, w1, w3, w2, toks):
        kind = toks.device.type
        h = None
        if kind == "cpu":
            y = ref.moe_ffn_ref(w1, w3, w2, toks)
        elif kind == "cuda":
            y, h = _capacity.fused_moe_ffn(w1, w3, w2, toks, keep_h=True)
        elif kind == "meta":
            y, h = _capacity.fused_outputs(w1, w3, w2, toks, kind)
        else:
            raise _no_kernel("fused_moe_ffn", toks.device)
        ctx.save_for_backward(w1, w3, w2, toks, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        w1, w3, w2, toks, h = ctx.saved_tensors
        dy = dy.contiguous()
        kind = toks.device.type
        if kind == "cpu":
            dx, dw1, dw3, dw2 = ref.moe_ffn_bwd_ref(w1, w3, w2, toks, dy)
        elif kind == "meta":
            (dx, da, db), _ = _capacity.dgrad_outputs(w1, w3, w2, toks, dy,
                                                      kind)
            (dw1, dw3, dw2), _ = _capacity.wgrad_outputs(toks, h, da, db, dy,
                                                         kind)
        else:
            dx, da, db = _capacity.moe_ffn_dgrad(w1, w3, w2, toks, dy)
            dw1, dw3, dw2 = _capacity.moe_ffn_wgrad(toks, h, da, db, dy)
        return dw1, dw3, dw2, dx


def ragged_moe_ffn(w1, w3, w2, toks, tile_group, row_offsets=None,
                   sizes=None, max_rows=None):
    """Ragged grouped SwiGLU FFN over a flat group-sorted (T, D) buffer
    and per-tile expert ids; the row tile is ``T // len(tile_group)``.
    ``row_offsets`` and ``sizes`` (the layout's segment starts and the
    plan's real rows per expert) let the kernel skip padding rows;
    ``max_rows`` (the most a tile is expected to hold) picks its row block
    and is never trusted. The plain version needs none of them: padding
    rows are zero. Differentiable in the weights and ``toks``; a gradient
    on the card needs ``row_offsets`` and ``sizes``."""
    if _wants_grad(w1, w3, w2, toks):
        return RaggedMoeFFN.apply(w1, w3, w2, toks, tile_group, row_offsets,
                                  sizes, max_rows)
    kind = toks.device.type
    if kind == "cpu":
        return ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tile_group)
    if kind == "cuda":
        return _ragged.ragged_moe_ffn(w1, w3, w2, toks, tile_group,
                                      row_offsets=row_offsets, sizes=sizes,
                                      max_rows=max_rows)
    if kind == "meta":
        return _ragged.ffn_outputs(w1, w3, w2, toks, tile_group, row_offsets,
                                   sizes, kind)[0]
    raise _no_kernel("ragged_moe_ffn", toks.device)


class RaggedMoeFFN(torch.autograd.Function):
    """The ragged FFN for autograd. On the card the forward is the kernel,
    keeping its bf16 scratch ``h`` as the saved activation, and the
    backward is K1 (``dx``, ``da``, ``db``) then K2 (the weights'
    gradients), over the plan's real rows, each on the TMA route wherever
    its operands allow (at the published widths they do); on the CPU both
    are the plain versions (:func:`~.ref.ragged_moe_ffn_bwd_ref`)."""

    @staticmethod
    def forward(ctx, w1, w3, w2, toks, tile_group, row_offsets, sizes,
                max_rows):
        kind = toks.device.type
        h = None
        if kind == "cpu":
            y = ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tile_group)
        elif kind in ("cuda", "meta"):
            if row_offsets is None or sizes is None:
                raise ValueError("ragged_moe_ffn: a gradient on the card "
                                 "needs the plan's row_offsets and sizes")
            if kind == "cuda":
                y, h = _ragged.ragged_moe_ffn(
                    w1, w3, w2, toks, tile_group, row_offsets=row_offsets,
                    sizes=sizes, max_rows=max_rows, keep_h=True)
            else:
                y, h, _ = _ragged.ffn_outputs(w1, w3, w2, toks, tile_group,
                                              row_offsets, sizes, kind)
        else:
            raise _no_kernel("ragged_moe_ffn", toks.device)
        ctx.save_for_backward(w1, w3, w2, toks, tile_group, row_offsets,
                              sizes, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        w1, w3, w2, toks, tile_group, row_offsets, sizes, h = \
            ctx.saved_tensors
        dy = dy.contiguous()
        kind = toks.device.type
        if kind == "cpu":
            dx, dw1, dw3, dw2 = ref.ragged_moe_ffn_bwd_ref(
                w1, w3, w2, toks, tile_group, dy)
        elif kind == "meta":
            (dx, da, db), _ = _ragged.dgrad_outputs(
                w1, w3, w2, toks, tile_group, row_offsets, sizes, dy, kind)
            (dw1, dw3, dw2), _ = _ragged.wgrad_outputs(
                toks, h, da, db, dy, row_offsets, sizes, kind)
        else:
            dx, da, db = _ragged.ragged_moe_ffn_dgrad(
                w1, w3, w2, toks, tile_group, row_offsets, sizes, dy)
            dw1, dw3, dw2 = _ragged.ragged_moe_ffn_wgrad(
                toks, h, da, db, dy, row_offsets, sizes)
        return dw1, dw3, dw2, dx, None, None, None, None


def router_topk(logits, top_k: int):
    """Softmax → top-k → renormalize: (T, E) → ((T, K) f32, (T, K) i32).
    On the card the logits-in entry of ``csrc/route_select.cu``."""
    kind = logits.device.type
    if kind == "cpu":
        return ref.router_topk_ref(logits, top_k)
    if kind == "cuda":
        return _route.router_topk(logits, top_k)
    if kind == "meta":
        return _route.topk_outputs(logits, top_k, kind)
    raise ValueError(f"router_topk: no kernel for device {logits.device}")


def route_select(x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                 top_k: int, row_valid=None):
    """A layer's routing stage — f32 router product, softmax, top-k,
    replica selection, masked tally, mean probabilities, aux loss — in one
    launch: → ``(weights, idx, slots, tally (E + 1,), mean_prob, aux)``
    (:func:`~.ref.route_select_ref`). Differentiable in ``x`` and
    ``router_w`` through the weights, the mean probabilities and aux."""
    args = (x, router_w, slots_of, n_copies, copy_cdf, route_seed, top_k,
            row_valid)
    if _wants_grad(x, router_w):
        return RouteSelect.apply(*args)
    kind = x.device.type
    if kind == "cpu":
        return ref.route_select_ref(*args)
    if kind == "cuda":
        return _route.route_select(*args)
    if kind == "meta":
        return _route.route_outputs(*args, kind=kind)[0]
    raise _no_kernel("route_select", x.device)


class RouteSelect(torch.autograd.Function):
    """The routing stage for autograd. The forward also keeps the softmax
    ``p`` (the kernel writes it beside its outputs on the card); the
    backward to the logits is ``route_select_bwd`` on the card and
    :func:`~.ref.route_select_dlogits_ref` on the CPU, then the router
    product's two matrix products (:func:`~.ref.router_product_bwd`).
    ``idx``, ``slots`` and ``tally`` are integer-valued and take no
    gradient."""

    @staticmethod
    def forward(ctx, x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                top_k, row_valid):
        args = (x, router_w, slots_of, n_copies, copy_cdf, route_seed,
                top_k, row_valid)
        kind = x.device.type
        if kind == "cpu":
            out = ref.route_select_ref(*args, with_probs=True)
        elif kind == "cuda":
            out = _route.route_select(*args, with_probs=True)
        elif kind == "meta":
            out = _route.route_outputs(*args, with_probs=True, kind=kind)[0]
        else:
            raise _no_kernel("route_select", x.device)
        weights, idx, slots, tally, mean_prob, aux, probs = out
        ctx.mark_non_differentiable(idx, slots, tally)
        ctx.save_for_backward(x, router_w, probs, idx, weights, row_valid)
        # the counts, kept apart from save_for_backward: the capacity
        # bodies write the drop column tally[E] after the forward, which
        # the backward does not read
        ctx.counts = tally[:router_w.shape[1]].detach()
        return weights, idx, slots, tally, mean_prob, aux

    @staticmethod
    def backward(ctx, dweights, _didx, _dslots, _dtally, dmean_prob, daux):
        x, router_w, probs, idx, weights, row_valid = ctx.saved_tensors
        kind = x.device.type
        if kind == "cpu":
            dl = ref.route_select_dlogits_ref(
                probs, idx, weights, ctx.counts, dweights, dmean_prob, daux,
                row_valid)
        else:
            bwd = (functools.partial(_route.route_bwd_outputs, kind=kind)
                   if kind == "meta" else _route.route_select_bwd)
            dl = bwd(probs, idx, weights, ctx.counts, dweights.contiguous(),
                     dmean_prob.contiguous(), daux.contiguous(), row_valid)
        dx, drouter = ref.router_product_bwd(x, router_w, dl)
        return dx, drouter, None, None, None, None, None, None


def _plain_flash():
    # imported at the first call: repro_torch.models imports this module
    from repro_torch.models import flash
    return flash


def flash_attention(q, k, v, *, causal=True, window=None, q_positions=None,
                    kv_positions=None, kv_valid=None):
    """Chunked attention over the GQA layout: q (B, Sq, KV, G, hd), k, v
    (B, Skv, KV, hd) → (B, Sq, KV, G, hd)
    (:func:`repro_torch.models.flash.flash_attention`). On the card the
    kernel ``flash_attn_fwd``, through :class:`FlashAttention` when an
    input requires a gradient; ``window`` a Python int there."""
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              kv_valid=kv_valid)
    kind = q.device.type
    if kind == "cpu":
        return _plain_flash().flash_attention(q, k, v, causal=causal,
                                              window=window, **kw)
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_positions,
                                    kv_positions, kv_valid)
    if kind == "cuda":
        return _flash.flash_attn_fwd(q, k, v, causal=causal, window=window,
                                     **kw)
    if kind == "meta":
        return _flash.attn_outputs(q, k, v, q_positions, kv_positions,
                                   kv_valid, kind)
    raise _no_kernel("flash_attention", q.device)


class FlashAttention(torch.autograd.Function):
    """The prefill attention for autograd. The forward is
    ``flash_attn_fwd`` on the card, keeping its output and the rows'
    softmax stats (m, l; on the CPU the plain version's); the backward
    recomputes the scores from them: on the card the kernels
    ``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkdv`` (one launch each),
    on ``meta`` their allocations and cost entries, on the CPU
    :func:`~repro_torch.models.flash.flash_attention_bwd`, chunk pair by
    chunk pair."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_positions, kv_positions,
                kv_valid):
        kind = q.device.type
        if kind == "cuda":
            out, m, l = _flash.flash_attn_fwd(
                q, k, v, causal=causal, window=window,
                q_positions=q_positions, kv_positions=kv_positions,
                kv_valid=kv_valid, return_stats=True)
        elif kind == "meta":
            out, m, l = _flash.attn_outputs(q, k, v, q_positions,
                                            kv_positions, kv_valid, kind,
                                            stats=True)
        elif kind == "cpu":
            out, m, l = _plain_flash().flash_attention(
                q, k, v, causal=causal, window=window,
                q_positions=q_positions, kv_positions=kv_positions,
                kv_valid=kv_valid, return_stats=True)
        else:
            raise _no_kernel("flash_attention", q.device)
        ctx.masks = dict(causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, m, l, q_positions, kv_positions,
                              kv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, qpos, kpos, kval = ctx.saved_tensors
        kw = dict(q_positions=qpos, kv_positions=kpos, kv_valid=kval)
        dout = dout.contiguous()
        kind = q.device.type
        if kind == "cuda":
            dq, dk, dv = _flash.flash_attn_bwd(q, k, v, out, dout, m, l,
                                               **kw, **ctx.masks)
        elif kind == "meta":
            (dq, dk, dv), _ = _flash.attn_bwd_outputs(q, k, v, out, dout, m,
                                                      l, kind=kind, **kw)
        else:
            dq, dk, dv = _plain_flash().flash_attention_bwd(
                q, k, v, out, dout, m, l, **kw, **ctx.masks)
        return dq, dk, dv, None, None, None, None, None


def flash_decode(q, k_cache, v_cache, pos, *, window=None, kpos_offset=0,
                 return_stats=False):
    """One token a lane against the cache: q (B, KV, G, hd), caches (B,
    S_max, KV, hd), ``pos`` (B,) → (B, KV, G, hd), or with
    ``return_stats`` ``(acc, m, l)``
    (:func:`repro_torch.models.flash.flash_decode`). On the card the
    kernel ``flash_decode``, through :class:`FlashDecode` when an input
    requires a gradient."""
    kw = dict(window=window, kpos_offset=kpos_offset,
              return_stats=return_stats)
    kind = q.device.type
    if kind == "cpu":
        return _plain_flash().flash_decode(q, k_cache, v_cache, pos, **kw)
    if _wants_grad(q, k_cache, v_cache):
        return FlashDecode.apply(q, k_cache, v_cache, pos, window,
                                 kpos_offset, return_stats)
    if kind == "cuda":
        return _flash.flash_decode(q, k_cache, v_cache, pos, **kw)
    if kind == "meta":
        return _flash.decode_outputs(q, k_cache, v_cache, pos, return_stats,
                                     kind)[0]
    raise _no_kernel("flash_decode", q.device)


class FlashDecode(torch.autograd.Function):
    """The decode step for autograd: the forward is the kernel on the card;
    the backward runs autograd of the plain version on the same inputs
    (one token's scores a lane: small)."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, pos, window, kpos_offset,
                return_stats):
        ctx.kw = dict(window=window, kpos_offset=kpos_offset,
                      return_stats=return_stats)
        kind = q.device.type
        if kind == "cuda":
            outs = _flash.flash_decode(q, k_cache, v_cache, pos, **ctx.kw)
        elif kind == "meta":
            outs = _flash.decode_outputs(q, k_cache, v_cache, pos,
                                         return_stats, kind)[0]
        elif kind == "cpu":
            outs = _plain_flash().flash_decode(q, k_cache, v_cache, pos,
                                               **ctx.kw)
        else:
            raise _no_kernel("flash_decode", q.device)
        ctx.save_for_backward(q, k_cache, v_cache, pos)
        return outs

    @staticmethod
    def backward(ctx, *douts):
        q, k_cache, v_cache, pos = ctx.saved_tensors
        ins = [t.detach().requires_grad_(True) for t in (q, k_cache,
                                                          v_cache)]
        with torch.enable_grad():
            outs = _plain_flash().flash_decode(*ins, pos, **ctx.kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = torch.autograd.grad(outs, ins, douts, allow_unused=True)
        return (*grads, None, None, None, None)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name; ``<name>.tma``
    counts those of an FFN kernel's launches (forward or backward) that
    took the TMA route; ``flash_attn_fwd.tma`` and
    ``flash_attn_fwd.tf32x3`` those of the attention's prefill on its
    Hopper and tf32x3 routes (the two add up to ``flash_attn_fwd``: its
    route is a function of (dtype, hd), :func:`.flash.route_of`), and so
    ``flash_attn_bwd_dq.tma`` / ``.tf32x3`` and ``flash_attn_bwd_dkdv.tma``
    / ``.tf32x3`` those of the backward's two kernels: ``.tma`` names
    ``route_of``'s bf16 route, whose backward kernels load through
    ``cp.async``, not TMA."""
    return {"fused_moe_ffn": _capacity.fused_moe_ffn.launches,
            "fused_moe_ffn.tma": _capacity.fused_moe_ffn.tma_launches,
            "moe_ffn_dgrad": _capacity.moe_ffn_dgrad.launches,
            "moe_ffn_dgrad.tma": _capacity.moe_ffn_dgrad.tma_launches,
            "moe_ffn_wgrad": _capacity.moe_ffn_wgrad.launches,
            "moe_ffn_wgrad.tma": _capacity.moe_ffn_wgrad.tma_launches,
            "ragged_moe_ffn": _ragged.ragged_moe_ffn.launches,
            "ragged_moe_ffn.tma": _ragged.ragged_moe_ffn.tma_launches,
            "router_topk": _route.router_topk.launches,
            "route_select": _route.route_select.launches,
            "ragged_moe_ffn_dgrad": _ragged.ragged_moe_ffn_dgrad.launches,
            "ragged_moe_ffn_dgrad.tma":
                _ragged.ragged_moe_ffn_dgrad.tma_launches,
            "ragged_moe_ffn_wgrad": _ragged.ragged_moe_ffn_wgrad.launches,
            "ragged_moe_ffn_wgrad.tma":
                _ragged.ragged_moe_ffn_wgrad.tma_launches,
            "route_select_bwd": _route.route_select_bwd.launches,
            "flash_attn_fwd": _flash.flash_attn_fwd.launches,
            "flash_attn_fwd.tma": _flash.flash_attn_fwd.tma_launches,
            "flash_attn_fwd.tf32x3": _flash.flash_attn_fwd.tf32x3_launches,
            "flash_decode": _flash.flash_decode.launches,
            "flash_attn_bwd_dq": _flash.flash_attn_bwd_dq.launches,
            "flash_attn_bwd_dq.tma": _flash.flash_attn_bwd_dq.tma_launches,
            "flash_attn_bwd_dq.tf32x3":
                _flash.flash_attn_bwd_dq.tf32x3_launches,
            "flash_attn_bwd_dkdv": _flash.flash_attn_bwd_dkdv.launches,
            "flash_attn_bwd_dkdv.tma":
                _flash.flash_attn_bwd_dkdv.tma_launches,
            "flash_attn_bwd_dkdv.tf32x3":
                _flash.flash_attn_bwd_dkdv.tf32x3_launches}


def reset_launch_counts() -> None:
    for fn in (_capacity.fused_moe_ffn, _capacity.moe_ffn_dgrad,
               _capacity.moe_ffn_wgrad, _ragged.ragged_moe_ffn,
               _ragged.ragged_moe_ffn_dgrad, _ragged.ragged_moe_ffn_wgrad):
        fn.launches = 0
        fn.tma_launches = 0
    for fn in (_route.router_topk, _route.route_select,
               _route.route_select_bwd, _flash.flash_decode):
        fn.launches = 0
    for fn in (_flash.flash_attn_fwd, _flash.flash_attn_bwd_dq,
               _flash.flash_attn_bwd_dkdv):
        fn.launches = fn.tma_launches = fn.tf32x3_launches = 0
