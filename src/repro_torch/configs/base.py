"""Architecture config schema + shape suite (assigned pool).

Every assigned architecture gets one module in this package defining a
``CONFIG`` (exact published numbers) and a ``SMOKE`` (reduced same-family
config for CPU tests). ``repro_torch.configs.get(name)`` resolves either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                        # dense-FFN inner dim (0 = no dense FFN)
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert FFN inner dim
    n_shared_experts: int = 0        # DeepSeek-style always-on experts
    moe_every: int = 1               # a layer is MoE if (l % moe_every == moe_offset)
    moe_offset: int = 0
    # --- attention pattern ---
    causal: bool = True              # False → encoder-only (no decode)
    window: int = 0                  # sliding-window size (0 = full attention)
    global_every: int = 0            # gemma3: 1 global layer per N (rest windowed)
    # --- hybrid (jamba) ---
    attn_every: int = 0              # 1 attention layer per N (rest Mamba); 0 = all attn
    # --- ssm ---
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0             # xlstm: 1 sLSTM per N blocks (rest mLSTM)
    # --- frontend stubs ---
    frontend: str = "none"           # none | audio | vision
    frontend_dim: int = 0            # precomputed feature dim fed by input_specs
    n_patches: int = 0               # vlm: image patches prepended to the sequence
    # --- misc ---
    mlp_gated: bool = True           # SwiGLU (True) vs GELU 2-matrix MLP (False)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                 # provenance tag from the assignment table

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return True  # every assigned arch has some attention (xlstm: none — see is_recurrent)

    @property
    def is_recurrent(self) -> bool:
        return self.family == "ssm"

    @property
    def is_decoder(self) -> bool:
        return self.causal

    def n_params(self) -> int:
        """Total parameter count (embeddings included once unless tied)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        L = self.n_layers
        n_attn = self._n_attn_layers()
        # attention
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        per = attn * n_attn
        # mamba layers
        n_mamba = L - n_attn if self.attn_every else 0
        if n_mamba:
            di = self.ssm_expand * d
            mamba = d * 2 * di + di * self.ssm_conv + di * (self.ssm_d_state * 2 + 2) \
                + di * self.ssm_d_state + di * d
            per += mamba * n_mamba
        if self.family == "ssm":
            di = self.ssm_expand * d
            per += L * (d * 2 * di + di * d + di * (3 * hd // max(hd, 1)))  # approx proj
        # FFN / MoE
        n_moe = self._n_moe_layers()
        n_dense_ffn = (L - n_moe) if self.d_ff else 0
        mats = 3 if self.mlp_gated else 2
        per += n_dense_ffn * mats * d * self.d_ff
        per += n_moe * (self.n_experts + self.n_shared_experts) * mats * d * self.moe_d_ff
        per += n_moe * d * self.n_experts   # router
        # norms (negligible) + frontend proj
        per += 2 * L * d
        if self.frontend_dim:
            per += self.frontend_dim * d
        return emb + per

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.n_params()
        full = self.n_params()
        n_moe = self._n_moe_layers()
        mats = 3 if self.mlp_gated else 2
        all_experts = n_moe * self.n_experts * mats * self.d_model * self.moe_d_ff
        active = n_moe * self.top_k * mats * self.d_model * self.moe_d_ff
        return full - all_experts + active

    def _n_moe_layers(self) -> int:
        if not self.is_moe:
            return 0
        return sum(1 for l in range(self.n_layers)
                   if l % self.moe_every == self.moe_offset)

    def _n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.attn_every:
            return sum(1 for l in range(self.n_layers) if l % self.attn_every == 0)
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


#: The assigned LM shape suite (applies to every arch, modulo skips).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Skip matrix (DESIGN.md §5). Returns (runnable, reason_if_not)."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or (cfg.window > 0 and cfg.global_every > 0)
                         or (cfg.window > 0))
        if not sub_quadratic:
            return False, "pure full-attention arch — 500k context skipped"
    return True, ""
