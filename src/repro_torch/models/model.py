"""Model assembly for attention-only archs: prefill and decode entry points.

The counterpart of ``repro.models.model``. Params carry the reference's
keys and leading ``n_blocks`` axis (a super-block is the smallest repeating
unit of the arch; one layer for the MoE archs), so carrying weights across
is a straight copy (:mod:`repro_torch.bridge`). A Python loop over blocks
takes the place of ``lax.scan``.

MoE placement enters as the ``moe_tables`` input (slot lookup tensors), so a
recalibration swaps tables and migrates weights without touching the step
functions.

Decode updates the KV cache in place (one new row per sequence) and returns
the same cache object; prefill returns a new per-request cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from .attention import attn_init
from .common import apply_rope, dense_init, mlp, rms_norm, rope_tables
from .flash import flash_attention, flash_decode
from .moe import moe_init, moe_layer
from .sharding import ShardingRules, build_copy_cdf, build_slots_of

__all__ = [
    "LayerSpec", "block_layout", "init_params", "make_moe_tables",
    "refresh_moe_share_tables", "prefill_fn", "decode_fn", "init_cache",
    "moe_perm_shape",
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


def moe_perm_shape(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_moe_layers, n_slots): one device holds one slot per expert."""
    nb, specs = block_layout(cfg)
    return nb * sum(1 for s in specs if s.ffn == "moe"), cfg.n_experts


def _attention_only(cfg: ArchConfig) -> List[LayerSpec]:
    nb, specs = block_layout(cfg)
    if any(s.mixer != "attn" for s in specs):
        raise NotImplementedError(
            f"{cfg.name}: SSM mixers (mamba/mLSTM/sLSTM) are not ported yet")
    return specs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params drawn with ``generator`` (which lives on ``device``):
    the reference's distributions and dtypes — N(0, 1/d_in) weights in
    ``dtype``, the router in f32, norms as f32 zeros — with the reference's
    keys and a leading ``n_blocks`` axis on every block leaf."""
    specs = _attention_only(cfg)
    nb, _ = block_layout(cfg)
    _, n_slots = moe_perm_shape(cfg) if cfg.is_moe else (0, 0)
    d, hd = cfg.d_model, cfg.hd
    lead = (nb,)

    def zeros():
        return torch.zeros((nb, d), dtype=torch.float32, device=device)

    layers = []
    for spec in specs:
        sub = {"ln1": zeros(),
               "mixer": attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                  hd, dtype, device, lead)}
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


def _mlp_init(generator, d, f, gated, dtype, device, lead):
    p = {"w1": dense_init(generator, d, f, dtype, device, lead),
         "w2": dense_init(generator, f, d, dtype, device, lead)}
    if gated:
        p["w3"] = dense_init(generator, d, f, dtype, device, lead)
    return p


def make_moe_tables(cfg: ArchConfig, perm: Optional[np.ndarray] = None,
                    n_slots: Optional[int] = None,
                    share: Optional[np.ndarray] = None,
                    r_max: Optional[int] = None, device=None):
    """The (slots_of, n_copies, copy_cdf) tensors of a placement, shaped
    (n_blocks, moe_per_block, E, r) / (…, E) / (…, E, r), on ``device``;
    None for non-MoE archs. ``perm`` (n_moe, n_slots) — logical expert per
    physical slot, None = contiguous; ``share`` — per-slot traffic
    fractions, None = uniform over copies; ``r_max`` pins the copy axis."""
    if not cfg.is_moe:
        return None
    nb, specs = block_layout(cfg)
    m = sum(1 for s in specs if s.ffn == "moe")
    n_moe, default_slots = moe_perm_shape(cfg)
    n_slots = default_slots if n_slots is None else int(n_slots)
    if perm is None:
        perm = np.tile(np.arange(n_slots, dtype=np.int32), (n_moe, 1))
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

def _run_attention(p, x, cfg, window, positions, cache=None, pos=None):
    """Prefill: returns (out, (k, v)); decode: writes the new row into the
    cache in place and returns (out, cache)."""
    B, S, D = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    q = (x @ p["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if cache is None:
        cos, sin = rope_tables(positions[None, :], hd, cfg.rope_theta)
        q = apply_rope(q.reshape(B, S, KV * G, hd), cos, sin) \
            .reshape(B, S, KV, G, hd)
        k = apply_rope(k, cos, sin)
        out = flash_attention(q, k, v, causal=cfg.causal, window=window,
                              q_positions=positions, kv_positions=positions)
        return out.reshape(B, S, H * hd) @ p["wo"], (k, v)
    k_cache, v_cache = cache
    cos, sin = rope_tables(pos[:, None], hd, cfg.rope_theta)   # (B, 1, hd/2)
    q = apply_rope(q.reshape(B, S, KV * G, hd), cos, sin).reshape(B, KV, G, hd)
    k = apply_rope(k, cos, sin)
    lanes = torch.arange(B, device=x.device)
    rows = pos.long()
    k_cache[lanes, rows] = k[:, 0].to(k_cache.dtype)
    v_cache[lanes, rows] = v[:, 0].to(v_cache.dtype)
    out = flash_decode(q, k_cache, v_cache, pos, window=window)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache


def _block_body(cfg, rules, specs, bp, x, *, windows_blk, moe_tables_blk,
                positions, cache_blk=None, pos=None):
    """One super-block forward. Returns (x, tallies (m, E+1), new caches)."""
    tallies, new_cache = [], []
    moe_i = 0
    for i, spec in enumerate(specs):
        sub = bp[i]
        h = rms_norm(x, sub["ln1"], cfg.norm_eps)
        window = None if windows_blk is None else int(windows_blk[i])
        cache = None if cache_blk is None else cache_blk[i]
        h, st = _run_attention(sub["mixer"], h, cfg, window, positions,
                               cache=cache, pos=pos)
        new_cache.append(st)
        x = x + h
        if spec.ffn == "none":
            continue
        h2 = rms_norm(x, sub["ln2"], cfg.norm_eps)
        if spec.ffn == "dense":
            h2 = mlp(sub["ffn"], h2, cfg.mlp_gated)
        else:
            so = nc = cdf = None
            if moe_tables_blk is not None:
                so, nc, cdf = (t[moe_i] for t in moe_tables_blk)
            # position-derived salt: decode positions advance every step,
            # so tiny batches re-draw their replica-selection uniforms
            seed = positions.sum().to(torch.int32)
            y, tally, _ = moe_layer(
                sub["ffn"], h2, top_k=cfg.top_k, n_experts=cfg.n_experts,
                rules=rules, slots_of=so, n_copies=nc, copy_cdf=cdf,
                route_seed=seed)
            if cfg.n_shared_experts:
                y = y + mlp(sub["shared"], h2, cfg.mlp_gated)
            tallies.append(tally)
            moe_i += 1
            h2 = y
        x = x + h2
    return x, tallies, new_cache


def _embed(params, tokens):
    return params["embed"][tokens]


def _unembed_w(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _run_blocks(cfg, rules, params, x, *, moe_tables, positions,
                cache=None, pos=None):
    """Loop over the ``n_blocks`` super-blocks (``lax.scan`` in the
    reference). Returns (x, tallies (n_moe, E+1), per-position caches)."""
    nb, specs = block_layout(cfg)
    win = _windows(cfg)
    tallies = []
    block_caches = []
    for b in range(nb):
        bp = [{k: _index_tree(v, b) for k, v in sub.items()}
              for sub in params["blocks"]]
        mt = None if moe_tables is None else tuple(t[b] for t in moe_tables)
        cb = None if cache is None else [(kc[b], vc[b]) for kc, vc in cache]
        x, tall, nc = _block_body(
            cfg, rules, specs, bp, x,
            windows_blk=None if win is None else win[b], moe_tables_blk=mt,
            positions=positions, cache_blk=cb, pos=pos)
        tallies.extend(tall)
        block_caches.append(nc)
    if cache is not None:
        new_cache = cache                     # updated in place
    else:
        new_cache = [(torch.stack([bc[i][0] for bc in block_caches]),
                      torch.stack([bc[i][1] for bc in block_caches]))
                     for i in range(len(specs))]
    if tallies:
        tall = torch.stack(tallies)
    else:
        width = cfg.n_experts + 1 if cfg.is_moe else 1
        tall = torch.zeros((0, width), dtype=torch.float32, device=x.device)
    return x, tall, new_cache


def _index_tree(v, b):
    if isinstance(v, dict):
        return {k: _index_tree(x, b) for k, x in v.items()}
    return v[b]


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1].float() @ _unembed_w(cfg, params).float()


def prefill_fn(cfg: ArchConfig, rules: Optional[ShardingRules] = None):
    """(params, batch, moe_tables) → (last-position logits (B, V) f32,
    cache, tallies (n_moe, E+1))."""
    _attention_only(cfg)

    def fn(params, batch, moe_tables=None):
        tokens = batch["tokens"]
        x = _embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x, tallies, cache = _run_blocks(cfg, rules, params, x,
                                        moe_tables=moe_tables,
                                        positions=positions)
        return _logits(cfg, params, x), cache, tallies

    return fn


def decode_fn(cfg: ArchConfig, rules: Optional[ShardingRules] = None):
    """(params, token (B, 1), cache, pos (B,), moe_tables) → (logits,
    cache, tallies). The cache is updated in place and returned."""
    _attention_only(cfg)

    def fn(params, token, cache, pos, moe_tables=None):
        x = _embed(params, token)
        pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                 (token.shape[0],))
        x, tallies, cache = _run_blocks(cfg, rules, params, x,
                                        moe_tables=moe_tables,
                                        positions=pos, cache=cache, pos=pos)
        return _logits(cfg, params, x), cache, tallies

    return fn


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Per-position ``(k, v)`` caches, each (n_blocks, batch, max_seq, KV,
    hd), matching the block loop's layout."""
    specs = _attention_only(cfg)
    nb, _ = block_layout(cfg)
    shape = (nb, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in specs]
