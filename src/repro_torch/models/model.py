"""Model assembly: the training loss, and the prefill, chunked-prefill and
decode entry points, for attention, Mamba, mLSTM and sLSTM mixers.

The counterpart of ``repro.models.model``. Params carry the reference's
keys and leading ``n_blocks`` axis (a super-block is the smallest repeating
unit of the arch; one layer for the MoE archs), so carrying weights across
is a straight copy (:mod:`repro_torch.bridge`). A Python loop over blocks
takes the place of ``lax.scan``.

MoE placement enters as the ``moe_tables`` input (slot lookup tensors), so a
recalibration swaps tables and migrates weights without touching the step
functions.

Decode and chunked prefill update the cache in place (one new KV row per
sequence, or one chunk's rows in one lane; a recurrent mixer's whole
state, copied over the old one) and return the same cache object; prefill
returns a new per-request cache. A cache is a list, one entry a layer
position: a ``(k, v)`` pair for attention, the mixer's state dict for a
recurrent one, every leaf with the leading ``n_blocks`` axis. ``phase``
("train", "prefill", "chunk", "decode") reaches the MoE layer, which picks
its dispatch body by it, as in the reference.

On a rank grid the rules (:class:`ShardingRules`) split the dense
layers over ``tp`` as the reference's do: attention by heads or by
context (:func:`_run_attention`), the dense MLP's F, the vocabulary of
the embedding, the head and the loss; the recurrent mixers by channels
(Mamba) or by heads (mLSTM, sLSTM) where ``tp`` divides them
(``ShardingRules.mixer_split``, :mod:`.ssm`); the dense and mixer weights
arrive FSDP-sliced and are gathered a block at a time
(:func:`_gather_dense`). Each
rank holds and computes only its own rows (:class:`_Rows`): its ``B/dp``
of the batch where ``dp`` divides it, and at train and prefill its
``S/tp`` of the sequence between blocks where ``tp`` divides it
(Megatron-SP: gathered before a column-parallel product, reduce-scattered
after a row-parallel one). The entry points take the global token arrays
on every rank and return whole logits and tallies; the cache is the
rank's own. A leaf held whole is read by ranks that see different rows,
so :func:`_sum_over_rows` sums its gradient over them, once, at the top
of each entry point.

:func:`loss_fn` is the reference's training loss. Its ``phase="train"``
pass keeps no per-layer k/v stack (the reference's ``nc = []``) and hands
each block its parameters through ``torch.unbind`` of the stacked leaves,
so the backward writes each stacked gradient once instead of adding a
full-size zero-padded slice per block.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .attention import attn_init
from . import collectives as C
from .common import (apply_rope, dense_init, matmul, mlp, rms_norm,
                     rope_tables, softmax_xent_chunked)
from .moe import (default_perm_a2a, default_perm_replicated, moe_init,
                  moe_layer, n_slots_a2a)
from .sharding import (DENSE_D_AXIS, MIXER_D_AXIS, MIXER_TP_CUT,
                       ShardingRules, build_copy_cdf, build_slots_of,
                       rank_group_sizes)
from . import ssm
from repro_torch.tree import leaves

__all__ = [
    "LayerSpec", "block_layout", "init_params", "count_params",
    "make_moe_tables",
    "refresh_moe_share_tables", "loss_fn", "prefill_fn", "prefill_chunk_fn",
    "decode_fn", "init_cache", "moe_perm_shape", "default_moe_perm",
]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                       # attn | mamba | mlstm | slstm
    ffn: str                         # dense | moe | none


def block_layout(cfg: ArchConfig) -> Tuple[int, List[LayerSpec]]:
    """(n_blocks, per-position layer specs)."""
    if cfg.family == "ssm":
        bs = cfg.slstm_every or 1
    elif cfg.attn_every:
        bs = math.lcm(cfg.attn_every, cfg.moe_every if cfg.is_moe else 1)
    else:
        bs = 1
    if cfg.n_layers % bs:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} % block={bs}")
    specs = []
    for i in range(bs):
        if cfg.family == "ssm":
            mixer = "slstm" if (cfg.slstm_every and i % cfg.slstm_every == 0) \
                else "mlstm"
        elif cfg.attn_every and i % cfg.attn_every != 0:
            mixer = "mamba"
        else:
            mixer = "attn"
        if cfg.is_moe and i % cfg.moe_every == cfg.moe_offset:
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        specs.append(LayerSpec(mixer, ffn))
    return cfg.n_layers // bs, specs


def _windows(cfg: ArchConfig) -> Optional[np.ndarray]:
    """(n_blocks, block_size) sliding-window sizes (0 = full attention)."""
    nb, specs = block_layout(cfg)
    if cfg.window <= 0:
        return None
    win = np.zeros((cfg.n_layers,), np.int32)
    for l in range(cfg.n_layers):
        is_global = cfg.global_every and (l % cfg.global_every
                                          == cfg.global_every - 1)
        win[l] = 0 if is_global else cfg.window
    return win.reshape(nb, len(specs))


def moe_perm_shape(cfg: ArchConfig, rules: Optional[ShardingRules] = None,
                   phase: str = "train") -> Tuple[int, int]:
    """(n_moe_layers, n_slots) for building placement permutations: E
    without a group, E padded to a multiple of the group for train and
    prefill (``n_slots_a2a``), ``e_loc`` times the decode fleet for
    decode (the reference's group branches; a one-rank group gives E)."""
    nb, specs = block_layout(cfg)
    n_moe = nb * sum(1 for s in specs if s.ffn == "moe")
    if rules is None or not rules.grouped:
        return n_moe, cfg.n_experts
    if phase == "decode":
        return n_moe, default_perm_replicated(1, cfg.n_experts,
                                              rules.decode_fleet).shape[1]
    return n_moe, n_slots_a2a(cfg.n_experts, rules.ep_size)


def default_moe_perm(cfg: ArchConfig, rules: Optional[ShardingRules] = None,
                     phase: str = "train") -> np.ndarray:
    """The reference's default placement (n_moe, n_slots): round-robin
    replication over the decode fleet at decode with a group, else
    contiguous with phantoms at the tail."""
    n_moe, _ = moe_perm_shape(cfg, rules, phase)
    if rules is not None and rules.grouped and phase == "decode":
        return default_perm_replicated(n_moe, cfg.n_experts,
                                       rules.decode_fleet)
    return default_perm_a2a(n_moe, cfg.n_experts,
                            rules.ep_size if rules is not None else 1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16, *, rules: Optional[ShardingRules] = None,
                phase: str = "train") -> Dict[str, Any]:
    """Random params drawn with ``generator`` (which lives on ``device``):
    the reference's distributions and dtypes — N(0, 1/d_in) weights in
    ``dtype``, the router in f32, norms as f32 zeros — with the reference's
    keys and a leading ``n_blocks`` axis on every block leaf. ``rules``
    and ``phase`` set the slot count (:func:`moe_perm_shape`); the tree is
    whole, and ``launch.sharding.shard_params`` takes a rank's slice."""
    nb, specs = block_layout(cfg)
    _, n_slots = moe_perm_shape(cfg, rules, phase) if cfg.is_moe else (0, 0)
    d = cfg.d_model
    lead = (nb,)

    def zeros():
        return torch.zeros((nb, d), dtype=torch.float32, device=device)

    layers = []
    for spec in specs:
        sub = {"ln1": zeros(),
               "mixer": _mixer_init(cfg, spec.mixer, generator, dtype,
                                    device, lead)}
        if spec.ffn != "none":
            sub["ln2"] = zeros()
        if spec.ffn == "dense":
            sub["ffn"] = _mlp_init(generator, d, cfg.d_ff, cfg.mlp_gated,
                                   dtype, device, lead)
        elif spec.ffn == "moe":
            sub["ffn"] = moe_init(generator, d=d, f=cfg.moe_d_ff,
                                  n_experts=cfg.n_experts, n_slots=n_slots,
                                  dtype=dtype, device=device, lead=lead)
            if cfg.n_shared_experts:
                sub["shared"] = _mlp_init(
                    generator, d, cfg.n_shared_experts * cfg.moe_d_ff,
                    cfg.mlp_gated, dtype, device, lead)
        layers.append(sub)
    params: Dict[str, Any] = {
        "embed": dense_init(generator, cfg.vocab, d, dtype, device),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=device),
        "blocks": layers,
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, d, cfg.vocab, dtype, device)
    if cfg.frontend_dim:
        params["frontend"] = dense_init(generator, cfg.frontend_dim, d,
                                        dtype, device)
    return params


def count_params(params) -> int:
    """The parameter count of a tree: its leaves' sizes summed (any
    device, ``meta`` too), the reference's ``count_params``."""
    return sum(t.numel() for t in leaves(params))


def _mixer_init(cfg, mixer, generator, dtype, device, lead):
    d = cfg.d_model
    if mixer == "attn":
        return attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         dtype, device, lead)
    if mixer == "mamba":
        return ssm.mamba_init(generator, d, expand=cfg.ssm_expand,
                              d_state=cfg.ssm_d_state, d_conv=cfg.ssm_conv,
                              dtype=dtype, device=device, lead=lead)
    init = ssm.mlstm_init if mixer == "mlstm" else ssm.slstm_init
    return init(generator, d, n_heads=cfg.n_heads, expand=cfg.ssm_expand,
                dtype=dtype, device=device, lead=lead)


def _mlp_init(generator, d, f, gated, dtype, device, lead):
    p = {"w1": dense_init(generator, d, f, dtype, device, lead),
         "w2": dense_init(generator, f, d, dtype, device, lead)}
    if gated:
        p["w3"] = dense_init(generator, d, f, dtype, device, lead)
    return p


def make_moe_tables(cfg: ArchConfig, rules: Optional[ShardingRules] = None,
                    perm: Optional[np.ndarray] = None, phase: str = "train",
                    n_slots: Optional[int] = None,
                    share: Optional[np.ndarray] = None,
                    r_max: Optional[int] = None, device=None):
    """The (slots_of, n_copies, copy_cdf) tensors of a placement, shaped
    (n_blocks, moe_per_block, E, r) / (…, E) / (…, E, r), on ``device``;
    None for non-MoE archs. ``perm`` (n_moe, n_slots) — logical expert per
    physical slot, None = the reference's default: round-robin
    replication over the decode fleet at decode, else contiguous with
    phantoms at the tail; ``share`` — per-slot traffic fractions, None =
    uniform over copies; ``r_max`` pins the copy axis."""
    if not cfg.is_moe:
        return None
    nb, specs = block_layout(cfg)
    m = sum(1 for s in specs if s.ffn == "moe")
    n_moe, default_slots = moe_perm_shape(cfg, rules, phase)
    n_slots = default_slots if n_slots is None else int(n_slots)
    if perm is None:
        perm = default_moe_perm(cfg, rules, phase)
    perm = np.atleast_2d(perm)
    if perm.shape != (n_moe, n_slots):
        raise ValueError(f"perm shape {perm.shape} != {(n_moe, n_slots)}")
    slots_of, n_copies = build_slots_of(perm, cfg.n_experts, n_slots,
                                        r_max=r_max)
    r = slots_of.shape[-1]
    copy_cdf = build_copy_cdf(perm, cfg.n_experts, n_slots, share=share,
                              r_max=r)
    E = cfg.n_experts
    return (torch.as_tensor(slots_of.reshape(nb, m, E, r), device=device),
            torch.as_tensor(n_copies.reshape(nb, m, E), device=device),
            torch.as_tensor(copy_cdf.reshape(nb, m, E, r), device=device))


def refresh_moe_share_tables(cfg: ArchConfig, moe_tables,
                             perm: np.ndarray, share: np.ndarray):
    """Rebuild only the ``copy_cdf`` entry of ``moe_tables`` for new
    shares; ``slots_of``/``n_copies`` are reused and shapes are kept."""
    if moe_tables is None:
        return None
    slots_of, n_copies, old_cdf = moe_tables
    nb, m, E, r = old_cdf.shape
    perm = np.atleast_2d(perm)
    copy_cdf = build_copy_cdf(perm, cfg.n_experts, perm.shape[1],
                              share=share, r_max=r)
    return (slots_of, n_copies,
            torch.as_tensor(copy_cdf.reshape(nb, m, E, r),
                            device=old_cdf.device))


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------

def _qkv(p, x, cfg, rope_pos):
    """Projections with RoPE at ``rope_pos`` (broadcast against (B, S)):
    q (B, S, KV, G, hd), k and v (B, S, KV, hd), KV the heads the weights
    hold (a rank's ``KV/tp`` when split by heads: ``wq``'s columns are in
    (KV, G, hd) order, so its contiguous slice holds those KV heads' G
    query heads each)."""
    B, S, D = x.shape
    hd = cfg.hd
    G = cfg.n_heads // cfg.n_kv_heads
    KV = p["wk"].shape[-1] // hd
    cos, sin = rope_tables(rope_pos, hd, cfg.rope_theta)
    q = apply_rope(matmul(x, p["wq"]).reshape(B, S, KV * G, hd), cos, sin)
    k = apply_rope(matmul(x, p["wk"]).reshape(B, S, KV, hd), cos, sin)
    v = matmul(x, p["wv"]).reshape(B, S, KV, hd)
    return q.reshape(B, S, KV, G, hd), k, v


def _run_attention(p, x, cfg, rules, window, positions, cache=None,
                   pos=None, seq=None):
    """Prefill: returns (out, (k, v)); decode: writes the new row into the
    cache in place and returns (out, cache).

    ``positions`` are the sequence's global positions; ``seq`` (sequence
    parallelism) the slice of them whose rows ``x`` holds, else None. On a
    grid (``rules``, :class:`ShardingRules`), split by heads: the weights
    and the cache hold the rank's heads, the input is gathered over ``tp``
    (under ``seq``) or replicated, and ``wo``'s partials reduce-scattered
    back to the rank's rows or summed. Context mode at prefill: the rank's
    rows are its query rows; their ``k`` and ``v`` are gathered over
    ``tp`` (smaller than the normed input under GQA), so each rank attends
    its queries against every key, and ``wo`` (replicated) gives its rows.
    At decode the cache is the rank's ``S_max/tp`` rows and the ranks'
    softmax stats are merged (:func:`_merge_decode`). Attention that does
    not split runs on the gathered rows and keeps the rank's."""
    B, S, D = x.shape
    tp = 1 if rules is None else rules.tp_size
    group = None if tp == 1 else rules.group(rules.tp_axes)
    heads = tp > 1 and rules.heads_split(cfg)
    if cache is None:
        if seq is not None and not heads and rules.attn_mode == "context":
            q, k, v = _qkv(p, x, cfg, positions[seq][None, :])
            k, v = C.gather_seq(k, group), C.gather_seq(v, group)
            out = ops.flash_attention(q, k, v, causal=cfg.causal,
                                      window=window,
                                      q_positions=positions[seq],
                                      kv_positions=positions)
            return matmul(out.reshape(B, S, -1), p["wo"]), (k, v)
        if seq is not None:
            x = C.gather_seq(x, group)
        elif heads:
            x = C.replicate(x, group)
        q, k, v = _qkv(p, x, cfg, positions[None, :])
        out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                  q_positions=positions,
                                  kv_positions=positions)
        out = matmul(out.reshape(B, x.shape[1], -1), p["wo"])
        if heads:
            out = (C.scatter_partials(out, group) if seq is not None
                   else C.sum_partials(out, group))
        elif seq is not None:
            out = out[:, seq]
        return out, (k, v)
    k_cache, v_cache = cache
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    lanes = torch.arange(B, device=x.device)
    rows = pos.long()
    if tp > 1 and rules.attn_mode == "context":
        out = _merge_decode(q[:, 0], k[:, 0], v[:, 0], k_cache, v_cache,
                            rows, window, rules, group)
    else:
        k_cache[lanes, rows] = k[:, 0].to(k_cache.dtype)
        v_cache[lanes, rows] = v[:, 0].to(v_cache.dtype)
        out = ops.flash_decode(q[:, 0], k_cache, v_cache, pos,
                               window=window)
    out = matmul(out.reshape(B, 1, -1), p["wo"])
    return (C.sum_partials(out, group) if heads else out), cache


def _merge_decode(q, k, v, k_cache, v_cache, pos, window, rules, group):
    """Context-parallel decode: this rank's cache is global rows ``[r n,
    (r + 1) n)``; the new k/v row is written only on the lanes whose
    ``pos`` falls there (other lanes rewrite their own row, never an index
    out of range), each rank attends its rows, and the ranks' un-
    normalised softmax stats merge as the reference's ``pmax`` and two
    ``psum`` (``src/repro/models/model.py:356-374``), the two sums in one
    exchange."""
    B, n = k_cache.shape[:2]
    off = rules.index(rules.tp_axes) * n
    lanes = torch.arange(B, device=q.device)
    upd = pos - off
    owned = ((upd >= 0) & (upd < n))[:, None, None]
    safe = upd.clamp(0, n - 1)
    for cbuf, new in ((k_cache, k), (v_cache, v)):
        cbuf[lanes, safe] = torch.where(owned, new.to(cbuf.dtype),
                                        cbuf[lanes, safe])
    acc, m, l = ops.flash_decode(q, k_cache, v_cache, pos, window=window,
                                 kpos_offset=off, return_stats=True)
    m_g = C.max_over(m, group)
    scale = torch.exp(m - m_g)
    both = C.sum_partials(torch.cat([acc * scale[..., None],
                                     (l * scale)[..., None]], -1), group)
    num, den = both[..., :-1], both[..., -1]
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def _run_attention_chunk(p, x, cfg, window, cache, positions, lane, offset,
                         n_valid, row_valid):
    """Chunked-prefill attention: one prompt chunk of one sequence against
    its lane of the full (batch, S_max) cache, written in place.

    ``row_valid`` masks the tail chunk's padding: padded rows never reach
    the cache (masked write) and unwritten cache rows never reach the
    scores (``kv_valid``), so a chunked prefill accumulates exactly the
    rows a whole-prompt prefill would. The caller keeps
    ``offset + C <= S_max``.
    """
    B, C, D = x.shape                    # B == 1: one sequence's chunk
    k_cache, v_cache = cache
    S_max = k_cache.shape[1]
    q, k, v = _qkv(p, x, cfg, positions[None, :])
    rows = slice(offset, offset + C)
    keep_new = row_valid[:, None, None]
    for cbuf, new in ((k_cache, k), (v_cache, v)):
        cbuf[lane, rows] = torch.where(keep_new, new[0].to(cbuf.dtype),
                                       cbuf[lane, rows])
    kv_pos = torch.arange(S_max, device=x.device)
    out = ops.flash_attention(q, k_cache[lane:lane + 1],
                              v_cache[lane:lane + 1], causal=cfg.causal,
                              window=window, q_positions=positions,
                              kv_positions=kv_pos,
                              kv_valid=kv_pos < offset + n_valid)
    return matmul(out.reshape(B, C, cfg.n_heads * cfg.hd), p["wo"]), cache


_SEQ = {"mamba": ssm.mamba_seq, "mlstm": ssm.mlstm_seq,
        "slstm": ssm.slstm_seq}
_STEP = {"mamba": ssm.mamba_step, "mlstm": ssm.mlstm_step,
         "slstm": ssm.slstm_step}


@dataclasses.dataclass(frozen=True)
class _Rows:
    """A rank's rows of a ``(B, S)`` call: ``b`` its batch rows (all but
    where ``batch``: the batch splits over ``dp``), ``s`` its positions of
    the sequence under sequence parallelism, else None (every row)."""
    b: slice
    s: Optional[slice] = None
    batch: bool = False


def _rows(rules, B: int, S: int, phase: str) -> _Rows:
    """The rows a rank holds of a ``(B, S)`` call in ``phase``."""
    if rules is None or rules.grid is None:
        return _Rows(slice(0, B))
    seq = rules.seq_rows(S, phase) if rules.seq_split(S, phase) else None
    return _Rows(rules.batch_rows(B), seq, rules.batch_split(B))


def _row_axes(rules, rows: _Rows, tp_split: bool) -> Tuple[str, ...]:
    """The axes whose ranks read a leaf on different rows: ``dp`` where
    the batch splits, and ``tp`` under sequence parallelism unless the
    leaf is split over ``tp`` (then each rank's slice works on every row
    of the sequence)."""
    axes = rules.dp_axes if rows.batch else ()
    if rows.s is not None and not tp_split:
        axes = axes + rules.tp_axes
    return axes


def _fsdp_summed(rules, rows: _Rows, tp_split: bool):
    """How a leaf gathered over the FSDP group gives its gradient back
    (``collectives.gather_shards``' ``summed``): reduce-scattered over the
    FSDP axes whose ranks read it on different rows (:func:`_row_axes`),
    and over the other FSDP axes, whose ranks read the same rows, each
    rank's own slice (``ShardingRules.fsdp_summed``)."""
    return rules.fsdp_summed(_row_axes(rules, rows, tp_split))


def _sum_over_rows(cfg, params, rules, rows: _Rows):
    """Each leaf the rank holds whole, read through ``replicate`` over the
    ranks that read it on other rows (:func:`_row_axes`): its gradient is
    summed over them, once a call. These are the norms, the attention and
    dense MLP weights (their ``tp`` slices over ``dp`` only), the
    embedding, the head and the frontend (its ``tp`` slice over ``dp``
    only, where it splits; the rest from its gather's reduce-scatter,
    :func:`_frontend`), the recurrent mixers: a split mixer's ``tp``
    slices over ``dp`` only, and its leaves (or a grouped cut's groups)
    that the rank holds whole but reads in part (Mamba's ``dt_bias`` and
    ``D_skip``, mLSTM's u half of ``up``, sLSTM's ``up``) over ``tp`` as
    well, where each rank adds its own share; a mixer that does not split
    as the norms. An FSDP-sliced leaf gets its sum over the FSDP axes
    from its gather's reduce-scatter (:func:`_fsdp_summed`), and the rest
    of it here. The MoE layer's router and experts are left to its
    bodies, which sum their gradients over the group they route."""
    if rules is None or rules.grid is None:
        return params
    _, specs = block_layout(cfg)
    split = [rules.mixer_split(cfg, spec.mixer) for spec in specs]
    if not (rows.batch or rows.s is not None or any(split)):
        return params
    fsdp = rules.fsdp_axes

    def rep(w, tp_split, sliced=False, over_tp=False):
        axes = _row_axes(rules, rows, tp_split)
        if over_tp:
            axes = axes + tuple(a for a in rules.tp_axes if a not in axes)
        if sliced:
            axes = tuple(a for a in axes if a not in fsdp)
        return C.replicate(w, rules.group(axes))

    def dense(p, split):
        return {k: rep(w, split, True) for k, w in p.items()}

    def mixer(p, kind):
        out = {}
        for k, w in p.items():
            sliced = k in MIXER_D_AXIS
            axis, groups = MIXER_TP_CUT[kind].get(k, (None, None))
            if axis is None:                        # whole, read in part
                out[k] = rep(w, True, sliced, over_tp=True)
            elif groups is None or all(groups):     # the rank's slice
                out[k] = rep(w, True, sliced)
            else:                                   # some groups whole
                dim = axis + 1
                sizes = rank_group_sizes(w.shape[dim], groups, rules.tp_size)
                out[k] = torch.cat([
                    rep(piece, True, sliced, over_tp=not cut)
                    for piece, cut in zip(w.split(sizes, dim), groups)], dim)
        return out

    vocab = rules.splits(cfg.vocab)
    out = dict(params)
    out["final_norm"] = rep(params["final_norm"], False)
    out["embed"] = rep(params["embed"], vocab, True)
    if "head" in params:
        out["head"] = rep(params["head"], vocab, True)
    if "frontend" in params:
        out["frontend"] = rep(params["frontend"], rules.splits(cfg.d_model))
    blocks = []
    for spec, sub, mixer_split in zip(specs, params["blocks"], split):
        sub = dict(sub)
        for n in ("ln1", "ln2"):
            if n in sub:
                sub[n] = rep(sub[n], False)
        if spec.mixer == "attn":
            sub["mixer"] = dense(sub["mixer"], rules.heads_split(cfg))
        elif mixer_split:
            sub["mixer"] = mixer(sub["mixer"], spec.mixer)
        else:
            sub["mixer"] = {k: rep(w, False, k in MIXER_D_AXIS)
                            for k, w in sub["mixer"].items()}
        if spec.ffn == "dense":
            sub["ffn"] = dense(sub["ffn"], rules.splits(cfg.d_ff))
        if "shared" in sub:
            sub["shared"] = dense(sub["shared"], rules.splits(
                cfg.n_shared_experts * cfg.moe_d_ff))
        blocks.append(sub)
    out["blocks"] = blocks
    return out


def _block_body(cfg, rules, specs, bp, x, *, windows_blk, moe_tables_blk,
                positions, phase, rows: _Rows, cache_blk=None, pos=None,
                chunk_ctx=None, route_seed=None, moe_row_valid=None):
    """One super-block forward on the rank's ``rows``. Returns (x, tallies
    (m, E+1), aux losses (a list, one a MoE layer), new caches: an
    attention position's (k, v), a recurrent mixer's new state: the
    rank's slice where the mixer splits, else whole).

    ``chunk_ctx`` — (lane, offset, n_valid, row_valid) of the chunked-
    prefill phase: attention goes through :func:`_run_attention_chunk`.
    ``route_seed`` and ``moe_row_valid`` (the padding mask, flat over the
    block's rows) go to every MoE layer; the caller computes them once a
    model call. A recurrent mixer split over ``tp`` takes its input and
    gives its partial output as the dense MLP does (replicated and summed,
    or under sequence parallelism gathered and reduce-scattered); one that
    does not split, whole on every rank, runs on the gathered sequence
    under sequence parallelism and keeps the rank's rows."""
    tallies, auxes, new_cache = [], [], []
    moe_i = 0
    seq = rows.s
    tp_group = None if rules is None else rules.group(rules.tp_axes)
    bp = _gather_dense(cfg, bp, specs, rules, rows)
    for i, spec in enumerate(specs):
        sub = bp[i]
        h = rms_norm(x, sub["ln1"], cfg.norm_eps)
        window = None if windows_blk is None else int(windows_blk[i])
        cache = None if cache_blk is None else cache_blk[i]
        if spec.mixer != "attn":
            fn = (_STEP if phase == "decode" else _SEQ)[spec.mixer]
            if rules is not None and rules.mixer_split(cfg, spec.mixer):
                kw = {} if seq is None else {"seq": True}
                h, st = fn(sub["mixer"], h, cache, group=tp_group, **kw)
            elif seq is None:
                h, st = fn(sub["mixer"], h, cache)
            else:
                h, st = fn(sub["mixer"], C.gather_seq(h, tp_group), cache)
                h = h[:, seq]
        elif phase == "chunk":
            lane, offset, n_valid, row_valid = chunk_ctx
            h, st = _run_attention_chunk(sub["mixer"], h, cfg, window, cache,
                                         positions, lane, offset, n_valid,
                                         row_valid)
        else:
            h, st = _run_attention(sub["mixer"], h, cfg, rules, window,
                                   positions, cache=cache, pos=pos, seq=seq)
        new_cache.append(st)
        x = x + h
        if spec.ffn == "none":
            continue
        h2 = rms_norm(x, sub["ln2"], cfg.norm_eps)
        if spec.ffn == "dense":
            h2 = mlp(sub["ffn"], h2, cfg.mlp_gated,
                     _tp_group(rules, cfg.d_ff), seq is not None)
        else:
            so = nc = cdf = None
            if moe_tables_blk is not None:
                so, nc, cdf = (t[moe_i] for t in moe_tables_blk)
            y, tally, aux = moe_layer(
                sub["ffn"], h2, top_k=cfg.top_k, n_experts=cfg.n_experts,
                rules=rules, slots_of=so, n_copies=nc, copy_cdf=cdf,
                route_seed=route_seed, phase=phase, row_valid=moe_row_valid,
                rows=None if rules is None or rules.grid is None
                else (rows.batch, seq is not None))
            if cfg.n_shared_experts:
                f = cfg.n_shared_experts * cfg.moe_d_ff
                y = y + mlp(sub["shared"], h2, cfg.mlp_gated,
                            _tp_group(rules, f), seq is not None)
            tallies.append(tally)
            auxes.append(aux)
            moe_i += 1
            h2 = y
        x = x + h2
    return x, tallies, auxes, new_cache


def _gather_dense(cfg, bp, specs, rules, rows: _Rows):
    """A block's params with the FSDP slices of its attention and dense
    MLP weights gathered over ``rules.fsdp`` (on their d_model axis). The
    gather's backward reduce-scatters the gradient over the FSDP axes
    whose ranks work on different rows, and over the others each rank
    keeps its own slice (:func:`_fsdp_summed`); so are the recurrent
    mixers' d_model slices (``MIXER_D_AXIS``). Other leaves (norms, the
    MoE layer, whose experts gather in its body) pass as they are."""
    group = None if rules is None else rules.group(rules.fsdp_axes)
    if group is None:
        return bp
    out = []
    for spec, sub in zip(specs, bp):
        sub = dict(sub)
        if spec.mixer != "attn":
            summed = _fsdp_summed(rules, rows,
                                  rules.mixer_split(cfg, spec.mixer))
            sub["mixer"] = {n: C.gather_shards(w, group, MIXER_D_AXIS[n],
                                               summed=summed)
                            if n in MIXER_D_AXIS else w
                            for n, w in sub["mixer"].items()}
        dense = [(k, split) for k, ok, split in (
            ("mixer", spec.mixer == "attn", rules.heads_split(cfg)),
            ("ffn", spec.ffn == "dense", rules.splits(cfg.d_ff)),
            ("shared", "shared" in sub, rules.splits(
                cfg.n_shared_experts * cfg.moe_d_ff))) if ok]
        for k, split in dense:
            summed = _fsdp_summed(rules, rows, split)
            sub[k] = {n: C.gather_shards(w, group, DENSE_D_AXIS[n],
                                         summed=summed)
                      for n, w in sub[k].items()}
        out.append(sub)
    return out


def _whole_top(cfg, params, rules, rows: _Rows):
    """The embedding and the head with their FSDP slices gathered (D of
    ``embed``, axis 0 of ``head``); the vocabulary stays split over ``tp``
    where it is."""
    group = None if rules is None else rules.group(rules.fsdp_axes)
    if group is None:
        return params
    summed = _fsdp_summed(rules, rows, rules.splits(cfg.vocab))
    out = dict(params)
    out["embed"] = C.gather_shards(params["embed"], group, 1, summed=summed)
    if not cfg.tie_embeddings:
        out["head"] = C.gather_shards(params["head"], group, 0,
                                      summed=summed)
    return out


def _tp_group(rules, n: int):
    """The ``tp`` group where an axis of ``n`` (a dense MLP's F, the
    vocabulary) splits over it, else ``None``."""
    if rules is None or not rules.splits(n):
        return None
    return rules.group(rules.tp_axes)


def _vocab(cfg, rules):
    """(tp group, first id of this rank's slice) when the vocabulary is
    split over ``tp``, else (None, 0)."""
    group = _tp_group(rules, cfg.vocab)
    if group is None:
        return None, 0
    return group, rules.index(rules.tp_axes) * (cfg.vocab // rules.tp_size)


def _batch_shape(cfg, batch) -> Tuple[int, int]:
    """(B, S) of a call on ``batch``: the frames of ``feats``, or the
    tokens behind the ``patches`` where a vision arch's batch has them."""
    if cfg.frontend == "audio":
        return tuple(batch["feats"].shape[:2])
    B, S = batch["tokens"].shape
    if cfg.frontend == "vision" and "patches" in batch:
        S += batch["patches"].shape[1]
    return B, S


def _frontend(cfg, params, rules, rows: _Rows):
    """``params["frontend"]`` (F, D) whole: where ``param_cuts`` cut its
    d_model over ``tp``, the rank's columns gathered; the gather's
    backward reduce-scatters the gradient where the ``tp`` ranks project
    different positions (sequence parallelism), else each keeps its
    columns' share."""
    w = params["frontend"]
    group = _tp_group(rules, cfg.d_model)
    return C.gather_shards(w, group, 1, summed=rows.s is not None)


def _embed(cfg, params, batch, rules=None, rows: Optional[_Rows] = None):
    """The rank's ``rows`` of the call's embedded input, and the offset of
    the first labelled position, the reference's ``_embed``.

    Audio: the rank's frames of ``batch["feats"]`` projected by
    ``params["frontend"]`` in the dtype the two promote to (f32 features
    give an f32 residual stream through bf16 weights, as in the
    reference), offset 0. Text: the lookup of ``batch["tokens"]``, vocab-
    parallel where the vocabulary is split (every position of the rank's
    batch rows looked up in the rank's slice, tokens outside it zero, the
    ranks' partials summed, or under sequence parallelism reduce-
    scattered to the rank's positions). Vision with ``batch["patches"]``
    (P of them): the patches projected and cast to the embedding's dtype
    before the tokens, offset P; the text's partials are zero at the
    patch positions of the reduce-scatter and the rank's patch positions
    take its projection of them. Decode and chunked prefill are text
    only."""
    B, S = _batch_shape(cfg, batch)
    rows = rows or _Rows(slice(0, B))
    seq = rows.s or slice(0, S)
    if cfg.frontend == "audio":
        feats = batch["feats"][rows.b][:, seq]
        return matmul(feats, _frontend(cfg, params, rules, rows)), 0
    tokens = batch["tokens"][rows.b]
    P = S - tokens.shape[1]
    w = params["embed"]
    group, off = _vocab(cfg, rules)
    if group is None:            # the rank's text positions
        x = w[tokens[:, max(seq.start - P, 0):max(seq.stop - P, 0)]]
    else:
        n = w.shape[0]
        local = tokens - off
        mine = ((local >= 0) & (local < n))[..., None]
        x = w[local.clamp(0, n - 1)]
        x = torch.where(mine, x, torch.zeros_like(x))
        if rows.s is None:
            x = C.sum_partials(x, group)
        else:
            if P:
                x = torch.cat([x.new_zeros((x.shape[0], P, x.shape[2])), x],
                              1)
            x = C.scatter_partials(x, group)
    if not P:
        return x, 0
    patches = batch["patches"][rows.b][:, min(seq.start, P):min(seq.stop, P)]
    proj = matmul(patches, _frontend(cfg, params, rules, rows)).to(w.dtype)
    if group is not None and rows.s is not None:
        x = x[:, proj.shape[1]:]       # the patch positions' zero rows
    return torch.cat([proj, x], 1), P


def _unembed_w(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _run_blocks(cfg, rules, params, x, *, phase, moe_tables, positions,
                rows: Optional[_Rows] = None, cache=None, pos=None,
                chunk_ctx=None):
    """Loop over the ``n_blocks`` super-blocks (``lax.scan`` in the
    reference) on the rank's ``rows`` (``positions`` the call's global
    ones: the sequence's, or the decode's lanes', ``pos`` the rank's
    lanes'). Returns (x, tallies (n_moe, E+1), the MoE layers' aux
    losses (a list), per-position caches; none when ``phase="train"``).
    With ``rules.remat`` the train phase checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes a
    block's forward from its input instead of keeping its activations, as
    the reference's ``jax.checkpoint`` of the scan body
    (``src/repro/models/model.py:573``)."""
    nb, specs = block_layout(cfg)
    win = _windows(cfg)
    rows = rows or _Rows(slice(0, x.shape[0]))
    tallies, auxes = [], []
    block_caches = []
    train = phase == "train"
    remat = train and rules is not None and rules.remat
    if train:
        per_block = _unbind_tree(params["blocks"], nb)
    seed = rv = None
    if cfg.is_moe:
        # position-derived salt, the same in every layer: decode positions
        # advance every step, so tiny batches re-draw their replica-
        # selection uniforms
        seed = positions.sum().to(torch.int32)
        if chunk_ctx is not None:
            rv = chunk_ctx[3][None, :].expand(x.shape[:2]).reshape(-1)
    for b in range(nb):
        bp = per_block[b] if train else [
            {k: _index_tree(v, b) for k, v in sub.items()}
            for sub in params["blocks"]]
        mt = None if moe_tables is None else tuple(t[b] for t in moe_tables)
        cb = None if cache is None else [_index_tree(c, b) for c in cache]
        body = functools.partial(
            _block_body, cfg, rules, specs, bp,
            windows_blk=None if win is None else win[b], moe_tables_blk=mt,
            positions=positions, phase=phase, rows=rows, cache_blk=cb,
            pos=pos, chunk_ctx=chunk_ctx, route_seed=seed, moe_row_valid=rv)
        if remat:
            x, tall, aux, nc = torch.utils.checkpoint.checkpoint(
                body, x, use_reentrant=False)
        else:
            x, tall, aux, nc = body(x)
        tallies.extend(tall)
        auxes.extend(aux)
        if cache is not None:
            # a recurrent state comes back new (the rank's slice where the
            # mixer splits): copy it over the old one (attention wrote its
            # rows in place already)
            for i, spec in enumerate(specs):
                if spec.mixer != "attn":
                    for k, leaf in cb[i].items():
                        leaf.copy_(nc[i][k])
        block_caches.append(nc)
    if train:
        new_cache = []                        # no state stack in training
    elif cache is not None:
        new_cache = cache                     # updated in place
    else:
        new_cache = [_stack_tree([bc[i] for bc in block_caches])
                     for i in range(len(specs))]
    if tallies:
        tall = torch.stack(tallies)
    else:
        width = cfg.n_experts + 1 if cfg.is_moe else 1
        tall = torch.zeros((0, width), dtype=torch.float32, device=x.device)
    return x, tall, auxes, new_cache


def _index_tree(v, b):
    if isinstance(v, dict):
        return {k: _index_tree(x, b) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_index_tree(x, b) for x in v)
    return v[b]


def _stack_tree(trees):
    """Per-block trees (a (k, v) pair or a state dict) → one tree whose
    leaves carry the leading ``n_blocks`` axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack_tree([t[i] for t in trees])
                     for i in range(len(first)))
    return torch.stack(trees)


def _split_blocks(v, nb: int):
    """``[block]`` trees of a stacked tree, one ``torch.unbind`` a leaf
    (module-level recursion: a nested self-calling closure would keep the
    views, and so the parameters, alive until the garbage collector
    runs)."""
    if isinstance(v, dict):
        parts = {k: _split_blocks(x, nb) for k, x in v.items()}
        return [{k: p[b] for k, p in parts.items()} for b in range(nb)]
    return torch.unbind(v, 0)


def _unbind_tree(blocks, nb: int):
    """Per-block parameter trees, ``[block][position]``, from the stacked
    leaves by one ``torch.unbind`` each: its backward stacks the blocks'
    gradients once."""
    per_pos = [_split_blocks(sub, nb) for sub in blocks]
    return [[pos[b] for pos in per_pos] for b in range(nb)]


def _logits(cfg, params, x, rules=None, rows: Optional[_Rows] = None):
    """Last-position logits (B, V) f32, whole: under sequence parallelism
    the last position is the last ``tp`` rank's, so the ranks' last rows
    are gathered over ``tp`` (``gather_shards``) and the last one taken; a
    split vocabulary's slices are gathered, then the ``dp`` ranks'
    lanes."""
    rows = rows or _Rows(slice(0, x.shape[0]))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[:, -1]
    if rows.s is not None:
        last = C.gather_shards(last[None], rules.group(rules.tp_axes), 0,
                               summed=False)[-1]
    logits = last.float() @ _unembed_w(cfg, params).float()
    group, _ = _vocab(cfg, rules)
    logits = C.gather_shards(logits, group, 1, summed=False)
    if rows.batch:
        logits = C.gather_shards(logits, rules.group(rules.dp_axes), 0,
                                 summed=False)
    return logits


def _top(cfg, params, rules, rows: _Rows):
    """The params as a call on ``rows`` reads them: the whole leaves'
    gradients summed over the rows' ranks, the embedding and head
    gathered."""
    return _whole_top(cfg, _sum_over_rows(cfg, params, rules, rows), rules,
                      rows)


def loss_fn(cfg: ArchConfig, rules: Optional[ShardingRules] = None,
            aux_weight: float = 0.01):
    """Training loss, the reference's: ``(params, batch, moe_tables) →
    (mean token xent + aux_weight · aux, (tallies (n_moe, E+1), aux))``,
    ``aux`` the MoE layers' load-balance losses summed (0 without
    experts). ``rules=None`` is the single-device ragged path (the
    reference's ``rules=None`` is its dense oracle). Differentiable:
    call ``backward()`` on the loss.

    ``batch`` is the reference's: ``tokens`` and ``labels`` (B, S);
    for an audio arch ``feats`` (B, S, F) and ``labels``; for a vision
    arch ``patches`` (B, P, F) too, before the tokens (B, S - P), whose
    ``labels`` (B, S - P) label the positions past the patches (the
    reference's ``x[:, off:]``).

    On a grid every rank takes the global ``batch`` and computes on its
    rows; the loss, the tallies and ``aux`` come back global on every
    rank. The xent is the sum over the rank's labelled rows (every one of
    its batch rows where the vocabulary splits over ``tp``: the final
    hidden state is gathered over ``tp`` for the vocab-parallel xent, as
    the reference's ``logits_spec`` has it) over the rank's share of the
    global count, averaged over the ranks that hold other rows: the
    global mean, also where the patches leave the ranks unequal text
    rows. The MoE bodies sum the tallies and average ``mean_prob`` over
    their group already."""

    def fn(params, batch, moe_tables=None):
        B, S = _batch_shape(cfg, batch)
        rows = _rows(rules, B, S, "train")
        params = _top(cfg, params, rules, rows)
        x, off = _embed(cfg, params, batch, rules, rows)
        positions = torch.arange(S, device=x.device)
        x, tallies, auxes, _ = _run_blocks(cfg, rules, params, x,
                                           phase="train",
                                           moe_tables=moe_tables,
                                           positions=positions, rows=rows)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        group, voff = _vocab(cfg, rules)
        n_labels = batch["labels"].numel()
        labels = batch["labels"][rows.b]
        if group is None and rows.s is not None:
            # the rank's positions s >= off, labelled at s - off
            seq = rows.s
            x = x[:, max(off - seq.start, 0):]
            labels = labels[:, max(seq.start - off, 0):
                            max(seq.stop - off, 0)]
        else:
            if group is not None:
                x = (C.gather_seq(x, group) if rows.s is not None
                     else C.replicate(x, group))  # column-parallel over V
            x = x[:, off:]
        axes = (() if rules is None or rules.grid is None
                else _row_axes(rules, rows, group is not None))
        # the rank's sum over its share of the global count, averaged
        # over the ranks that hold other rows: the global mean, also
        # where the patches leave the ranks unequal text rows
        n_ranks = 1 if not axes else rules.axis_size(axes)
        loss = softmax_xent_chunked(x, _unembed_w(cfg, params), labels,
                                    group=group, vocab_offset=voff,
                                    denom=n_labels / n_ranks)
        if axes:
            loss = C.mean_over(loss, rules.group(axes))
        aux = (torch.stack(auxes).sum() if auxes else
               torch.zeros((), dtype=torch.float32, device=x.device))
        return loss + aux_weight * aux, (tallies, aux)

    return fn


def prefill_fn(cfg: ArchConfig, rules: Optional[ShardingRules] = None):
    """(params, batch, moe_tables) → (last-position logits (B, V) f32,
    cache, tallies (n_moe, E+1)). ``batch`` is the loss's without
    ``labels``; the cache covers every position, a vision arch's patches
    too. On a grid ``batch`` is the global one; the logits and tallies
    come back whole on every rank, the cache is the rank's: its ``B/dp``
    lanes, and its KV heads in heads mode (every row of the prompt, in
    both modes)."""

    def fn(params, batch, moe_tables=None):
        B, S = _batch_shape(cfg, batch)
        rows = _rows(rules, B, S, "prefill")
        params = _top(cfg, params, rules, rows)
        x, _ = _embed(cfg, params, batch, rules, rows)
        positions = torch.arange(S, device=x.device)
        x, tallies, _, cache = _run_blocks(cfg, rules, params, x,
                                           phase="prefill",
                                           moe_tables=moe_tables,
                                           positions=positions, rows=rows)
        return _logits(cfg, params, x, rules, rows), cache, tallies

    return fn


def prefill_chunk_fn(cfg: ArchConfig, rules: Optional[ShardingRules] = None):
    """Chunked prefill: one fixed-width prompt chunk into one cache lane.

    ``(params, tokens (1, C), cache, lane, offset, n_valid, moe_tables)`` →
    ``(logits (1, V) at the chunk's last valid row, cache, tallies)``; the
    cache is updated in place. ``lane``/``offset``/``n_valid`` are ints;
    the caller keeps ``offset + C <= max_seq``. Padded tail rows are
    masked out of the cache write, the attention scores and the MoE
    tallies, so the final chunk's logits and cache match a whole-prompt
    prefill. Logits are meaningful only on the chunk that completes the
    prompt. Runs without an expert-parallel group, as the reference runs
    it without a mesh, and for attention mixers only, as the reference.
    """
    _, specs = block_layout(cfg)
    if any(s.mixer != "attn" for s in specs):
        raise NotImplementedError(
            f"{cfg.name}: chunked prefill needs a resumable per-position "
            "cache; SSM/hybrid mixers carry recurrent state and are not "
            "supported")
    if rules is not None and rules.grouped:
        raise NotImplementedError(
            "chunked prefill runs without an expert-parallel group (the "
            "reference's single-device configuration); a group of "
            f"{rules.ep_size} rank(s) is not supported")

    def fn(params, tokens, cache, lane: int, offset: int, n_valid: int,
           moe_tables=None):
        x, _ = _embed(cfg, params, {"tokens": tokens})
        n = x.shape[1]
        rows = torch.arange(n, device=x.device)
        positions = offset + rows
        x, tallies, _, cache = _run_blocks(
            cfg, rules, params, x, phase="chunk", moe_tables=moe_tables,
            positions=positions, cache=cache,
            chunk_ctx=(lane, offset, n_valid, rows < n_valid))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        last = x[0, max(n_valid - 1, 0)]
        logits = last.float() @ _unembed_w(cfg, params).float()
        return logits[None], cache, tallies

    return fn


def decode_fn(cfg: ArchConfig, rules: Optional[ShardingRules] = None):
    """(params, token (B, 1), cache, pos (B,), moe_tables) → (logits,
    cache, tallies). The cache is updated in place and returned; every
    lane steps, busy or idle, as in the reference. On a grid ``token`` and
    ``pos`` are the global lanes' and the cache the rank's
    (``launch.sharding.rank_cache``: its ``B/dp`` lanes where ``dp``
    divides B); the logits (B, V) and tallies come back whole."""

    def fn(params, token, cache, pos, moe_tables=None):
        B = token.shape[0]
        rows = _rows(rules, B, 1, "decode")
        params = _top(cfg, params, rules, rows)
        x, _ = _embed(cfg, params, {"tokens": token}, rules, rows)
        pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                 (B,))
        x, tallies, _, cache = _run_blocks(cfg, rules, params, x,
                                           phase="decode",
                                           moe_tables=moe_tables,
                                           positions=pos, rows=rows,
                                           cache=cache, pos=pos[rows.b])
        return _logits(cfg, params, x, rules, rows), cache, tallies

    return fn


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Per-position caches matching the block loop's layout: ``(k, v)``,
    each (n_blocks, batch, max_seq, KV, hd), for attention; the mixer's
    state tree for a recurrent position, every leaf zeros (the mLSTM and
    sLSTM stabiliser ``m`` too, as the reference's cache) with the leading
    ``n_blocks`` axis."""
    nb, specs = block_layout(cfg)
    d = cfg.d_model
    out = []
    for spec in specs:
        if spec.mixer == "attn":
            shape = (nb, batch, max_seq, cfg.n_kv_heads, cfg.hd)
            out.append((torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device)))
            continue
        if spec.mixer == "mamba":
            st = ssm.mamba_state_init(batch, d, expand=cfg.ssm_expand,
                                      d_state=cfg.ssm_d_state,
                                      d_conv=cfg.ssm_conv, dtype=dtype)
        else:
            init = (ssm.mlstm_state_init if spec.mixer == "mlstm"
                    else ssm.slstm_state_init)
            st = init(batch, d, n_heads=cfg.n_heads, expand=cfg.ssm_expand)
        out.append({k: torch.zeros((nb,) + a.shape, dtype=a.dtype,
                                   device=device) for k, a in st.items()})
    return out
