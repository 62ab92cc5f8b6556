"""Sharding rules and the placement lookup tables.

The port's :class:`ShardingRules` holds what the model reads: the MoE
implementation, the dispatch body, the expert-parallel group, the ragged
row tile and the capacity factor, and — on a rank grid
(:class:`repro_torch.launch.mesh.Grid`) — the reference's axis roles
(``dp``, ``tp``, ``ep``, ``ep_all``, ``fsdp``, ``attn_mode``,
``decode_expert_tp``), with the grid in place of its ``Mesh``.

On a grid the dense layers split over ``tp`` as the reference's rules
split them: attention by heads (:func:`heads_ok`) or, in ``"context"``
mode, by query rows at prefill and by cache rows at decode; the dense
MLP's F; the vocabulary of the embedding and the unembedding where it
divides. The dense weights are also FSDP-sliced over ``fsdp`` and
gathered a block at a time. Each rank holds and computes only its own
rows: the batch splits over ``dp`` where ``dp`` divides it
(:meth:`ShardingRules.batch_split`, the reference's ``dp_ok``), and at
train and prefill the residual stream between blocks splits over ``tp``
along the sequence where ``tp`` divides it
(:meth:`ShardingRules.seq_split`, the reference's ``seq_ok``: Megatron
sequence parallelism). Where neither divides, the rows stay whole on
every rank. The recurrent mixers split over ``tp`` as well
(:meth:`ShardingRules.mixer_split`, :data:`MIXER_TP_CUT`): Mamba by
channels where ``tp`` divides ``di``, mLSTM and sLSTM by heads where it
divides the heads; a mixer that does not split is whole on every rank and
runs on the gathered sequence, keeping the rank's rows. ``tp=None`` keeps
every dense layer and mixer replicated and the sequence whole.

``build_slots_of`` and ``build_copy_cdf`` are the reference's numpy table
builders (``repro.models.sharding``), copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.placement import copy_share_cdf

__all__ = ["ShardingRules", "heads_ok", "DENSE_D_AXIS", "DENSE_TP_AXIS",
           "MIXER_D_AXIS", "MIXER_TP_CUT", "MIXER_STATE_TP_AXIS",
           "rank_group_sizes", "build_slots_of", "build_copy_cdf"]


_IMPLS = ("ragged", "capacity")
_DISPATCHES = ("auto", "a2a", "replicated", "dense")
_ATTN_MODES = ("heads", "context")

#: a dense block leaf's d_model axis (without the leading ``n_blocks``),
#: which FSDP slices, and its tensor-parallel axis: the heads or F of the
#: column-parallel in-projections, the rows of the row-parallel ones
#: (``param_specs``, ``src/repro/launch/sharding.py:120-128``)
DENSE_D_AXIS = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "w1": 0, "w3": 0,
                "w2": 1}
DENSE_TP_AXIS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w1": 1, "w3": 1,
                 "w2": 0}


#: a recurrent mixer's leaves (without the leading ``n_blocks``) that FSDP
#: slices on their d_model axis, as the reference's ``f``
MIXER_D_AXIS = {"in_proj": 0, "out_proj": 1, "up": 0, "down": 1}

#: how ``tp`` cuts a split recurrent mixer's leaves (without the leading
#: ``n_blocks``): leaf → (axis, groups). ``groups`` ``None``: the axis cut
#: in contiguous blocks; else the axis seen as ``len(groups)`` equal groups,
#: the rank taking its block of each group flagged True and every group
#: flagged False whole. Mamba by channels: ``in_proj``'s u and z halves
#: (``split`` after the product), ``conv_w``'s and ``dt_proj``'s columns,
#: ``x_proj``'s, ``A_log``'s and ``out_proj``'s rows. mLSTM by heads:
#: ``wq``/``wk``/``wv``'s columns, ``w_if``'s input- and forget-gate heads,
#: ``up``'s z half (its u half whole: every head's q, k and v read all of
#: u), ``ln_scale``'s channels, ``down``'s rows. sLSTM by heads:
#: ``w_gates``' columns (each head's 4 hd contiguous), ``r_gates``' heads,
#: ``down``'s rows. The leaves left out are whole on every rank: Mamba's
#: ``dt_bias`` and ``D_skip`` (the rank reads its channels), sLSTM's
#: ``up``.
MIXER_TP_CUT = {
    "mamba": {"in_proj": (1, (True, True)), "conv_w": (1, None),
              "x_proj": (0, None), "dt_proj": (1, None), "A_log": (0, None),
              "out_proj": (0, None)},
    "mlstm": {"up": (1, (False, True)), "wq": (1, None), "wk": (1, None),
              "wv": (1, None), "w_if": (1, (True, True)),
              "ln_scale": (0, None), "down": (0, None)},
    "slstm": {"w_gates": (1, None), "r_gates": (0, None),
              "down": (0, None)},
}

#: the axis ``tp`` cuts of a split mixer's state leaves (without the
#: leading ``n_blocks``; the lanes first): Mamba's channels, the heads of
#: mLSTM and sLSTM
MIXER_STATE_TP_AXIS = {
    "mamba": {"h": 1, "conv": 2},
    "mlstm": {"C": 1, "n": 1, "m": 1},
    "slstm": {"c": 1, "n": 1, "h": 1, "m": 1},
}


def rank_group_sizes(size: int, groups: Tuple[bool, ...], n: int) -> list:
    """The sizes of a rank's pieces of an axis of ``size`` (the rank's)
    cut as ``groups`` over ``n`` ranks: each group flagged True a rank's
    block, each other group whole."""
    n_cut = sum(groups)
    unit, rem = divmod(size, n * (len(groups) - n_cut) + n_cut)
    if rem:
        raise ValueError(f"an axis of {size} is not {groups} over {n}")
    return [unit if cut else unit * n for cut in groups]


def heads_ok(n_heads: int, n_kv_heads: int, tp: int) -> bool:
    """Whether attention splits by heads over ``tp`` ranks: both head
    counts divide and no rank is left without a head (the reference's
    ``heads_ok``, ``src/repro/launch/sharding.py:45-47``)."""
    return n_heads % tp == 0 and n_kv_heads % tp == 0 and tp <= n_heads


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """How the model maps onto one device or a grid of ranks.

    ``moe_impl`` — ``"ragged"``: sort-based dropless dispatch, the grouped
    FFN over occupied tiles only; ``"capacity"``: fixed per-slot buckets
    of ``capacity`` rows, overflowing assignments dropped and counted in
    the tally's last column, the capacity FFN over every bucket.

    ``ep_ranks`` — the expert-parallel group, in the reference's terms:

    * ``0`` without a grid — no group: the reference's ``mesh=None``.
      Ragged runs the single-device ragged dispatch; capacity runs the
      dense oracle (every expert on every token, nothing dropped).
    * ``1`` without a grid — a one-rank group: the reference's one-device
      mesh (``ep=ep_all=("model",)``, ``dp=()``, ``fsdp=None``). Capacity
      runs the a2a body at prefill and the replicated body at decode, as
      ``moe_dispatch`` selects, with ``all_to_all`` and ``psum`` the
      identity; ragged computes what the reference's one-rank ragged
      bodies compute.
    * with a ``grid`` — the grid's ``ep`` axes are the group, whose size
      is ``grid.axis_size(ep)`` (``ep_size``); ``ep_ranks`` stays 0 and
      a non-zero value is refused. The four bodies
      of the reference run over ``torch.distributed``: a2a (train,
      prefill) over ``ep`` with the batch over ``dp``, the expert weights
      FSDP-sharded over ``fsdp`` on their axis 1; replicated (decode) over
      ``ep_all``, or, with ``decode_expert_tp``, slots over ``ep`` and
      each expert's F sliced over the rest of ``ep_all``. Axis names the
      grid lacks are dropped, as the reference drops axes its mesh lacks.

    ``moe_dispatch`` — ``"auto"`` (decode → replicated, else a2a),
    ``"a2a"``, ``"replicated"`` or ``"dense"``; read only with a group.
    ``moe_block_m`` — the ragged row tile: a multiple of the CUDA kernel's
    64-row block on the card, any size on the CPU.

    ``tp`` — the grid axis the dense layers split over (``None``: none,
    every dense layer replicated); ``attn_mode`` — ``"heads"`` (each rank
    a contiguous block of ``H/tp`` query and ``KV/tp`` KV heads, where
    :func:`heads_ok`; else attention runs replicated) or ``"context"``
    (prefill: each rank its ``S/tp`` query rows against every key, where
    ``tp`` divides S; decode: the cache's rows split over the ranks, where
    ``tp`` divides ``S_max``, the online-softmax stats merged). ``fsdp``
    slices the dense weights as well as the experts.

    ``remat`` — recompute each block in the backward of the train phase
    (``torch.utils.checkpoint``). Off by default, where the reference's
    default is on: the port's ``rules=None`` means ``ShardingRules()``,
    and the reference's ``rules=None`` does not checkpoint;
    ``launch.sharding.make_rules`` turns it on for training, as the
    reference's does.
    """

    moe_impl: str = "ragged"
    moe_dispatch: str = "auto"
    ep_ranks: int = 0
    moe_block_m: int = 128
    capacity_factor: float = 1.25
    grid: Optional[object] = None
    dp: Tuple[str, ...] = ("pod", "data")
    tp: Optional[str] = "model"
    ep: Tuple[str, ...] = ("model",)
    ep_all: Tuple[str, ...] = ("pod", "data", "model")
    fsdp: Optional[Union[str, Tuple[str, ...]]] = "data"
    decode_expert_tp: bool = False
    attn_mode: str = "heads"
    remat: bool = False

    def __post_init__(self):
        if self.moe_impl not in _IMPLS:
            raise ValueError(f"moe_impl must be one of {_IMPLS}, "
                             f"got {self.moe_impl!r}")
        if self.moe_dispatch not in _DISPATCHES:
            raise ValueError(f"moe_dispatch must be one of {_DISPATCHES}, "
                             f"got {self.moe_dispatch!r}")
        if self.attn_mode not in _ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {_ATTN_MODES}, "
                             f"got {self.attn_mode!r}")
        if self.ep_ranks < 0:
            raise ValueError(f"ep_ranks must be >= 0, got {self.ep_ranks}")
        if self.grid is None:
            if self.ep_ranks > 1:
                raise ValueError(
                    f"ep_ranks={self.ep_ranks}: a group of more than one "
                    "rank needs a grid (repro_torch.launch.mesh.make_mesh)")
        elif self.ep_ranks:
            raise ValueError(
                f"ep_ranks={self.ep_ranks} with a grid: the grid's ep axes "
                "give the group's size; leave ep_ranks 0")

    @property
    def grouped(self) -> bool:
        """Whether the MoE layer runs over an expert-parallel group (a
        grid, or ``ep_ranks=1``)."""
        return self.grid is not None or self.ep_ranks > 0

    # -- grid helpers (the reference's mesh helpers) ----------------------

    def _axes(self, axes) -> Tuple[str, ...]:
        if self.grid is None:
            return ()
        return self.grid.canon(axes)

    def axis_size(self, axes) -> int:
        return 1 if self.grid is None else self.grid.axis_size(axes)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self._axes(self.dp)

    @property
    def ep_axes(self) -> Tuple[str, ...]:
        return self._axes(self.ep)

    @property
    def ep_all_axes(self) -> Tuple[str, ...]:
        return self._axes(self.ep_all)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        return self._axes(self.fsdp)

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        return self._axes(self.tp) if self.tp else ()

    @property
    def tp_size(self) -> int:
        """Ranks the dense layers split over (1 without a grid)."""
        return self.axis_size(self.tp_axes)

    def group(self, axes):
        """The process group over ``axes`` (``None``: one rank)."""
        return None if self.grid is None else self.grid.group(axes)

    def fsdp_summed(self, apart):
        """``collectives.gather_shards``' ``summed`` for a leaf gathered
        over ``fsdp`` and read on different rows by the ranks that differ
        over the axes ``apart``: its gradient reduce-scattered over the
        FSDP axes in ``apart``, and over the other FSDP axes, whose ranks
        read the same rows and so hold the same gradient, each rank's own
        slice, counted once. ``True`` where ``apart`` holds every FSDP
        axis of more than one rank, ``False`` where it holds none."""
        fsdp = self.fsdp_axes
        axes = tuple(a for a in fsdp if a in apart)
        n = self.axis_size(axes)
        if n == 1 or n == self.axis_size(fsdp):
            return n > 1
        return (self.group(axes),
                [self.grid.index(fsdp, c) for c in self.grid.members(axes)])

    def index(self, axes) -> int:
        """This rank's place in the group over ``axes``."""
        return 0 if self.grid is None else self.grid.index(axes)

    def heads_split(self, cfg) -> bool:
        """Attention runs split by heads (``attn_mode="heads"`` and
        :func:`heads_ok`), as ``_attn_specs`` checks it at run time."""
        return (self.tp_size > 1 and self.attn_mode == "heads"
                and heads_ok(cfg.n_heads, cfg.n_kv_heads, self.tp_size))

    def mixer_split(self, cfg, mixer: str) -> bool:
        """A recurrent mixer (``"mamba"``, ``"mlstm"``, ``"slstm"``) splits
        over ``tp`` (:data:`MIXER_TP_CUT`): Mamba where ``tp`` divides its
        ``di`` channels, mLSTM and sLSTM where it divides the heads."""
        if self.tp_size == 1 or mixer not in MIXER_TP_CUT:
            return False
        n = (cfg.ssm_expand * cfg.d_model if mixer == "mamba"
             else cfg.n_heads)
        return n % self.tp_size == 0

    def context_split(self, n_rows: int) -> bool:
        """Context-parallel attention over ``n_rows`` (the prefill's S or
        the cache's ``S_max``): ``attn_mode="context"`` and ``tp``
        divides them."""
        return (self.tp_size > 1 and self.attn_mode == "context"
                and n_rows % self.tp_size == 0)

    @property
    def dp_size(self) -> int:
        """Ranks the batch splits over (1 without a grid)."""
        return self.axis_size(self.dp_axes)

    def batch_split(self, B: int) -> bool:
        """A batch of ``B`` splits over ``dp``: ``dp > 1`` divides it (the
        reference's ``dp_ok``, ``src/repro/launch/sharding.py:169``)."""
        return self.dp_size > 1 and B % self.dp_size == 0

    def seq_split(self, S: int, phase: str) -> bool:
        """The residual stream of ``S`` rows splits over ``tp`` along the
        sequence: not at decode, ``tp > 1`` divides ``S`` (the reference's
        ``seq_ok``, ``src/repro/models/model.py:558-561``)."""
        return (phase != "decode" and self.tp_size > 1
                and S % self.tp_size == 0)

    def batch_rows(self, B: int) -> slice:
        """This rank's rows of a batch of ``B``: its ``B/dp`` where
        :meth:`batch_split`, else all (the counterpart of the reference's
        ``batch_specs``)."""
        if not self.batch_split(B):
            return slice(0, B)
        n = B // self.dp_size
        i = self.index(self.dp_axes)
        return slice(i * n, (i + 1) * n)

    def seq_rows(self, S: int, phase: str) -> slice:
        """This rank's positions of a sequence of ``S``: its ``S/tp`` where
        :meth:`seq_split`, else all."""
        if not self.seq_split(S, phase):
            return slice(0, S)
        n = S // self.tp_size
        i = self.index(self.tp_axes)
        return slice(i * n, (i + 1) * n)

    def splits(self, n: int) -> bool:
        """An axis of ``n`` (the vocabulary, a dense MLP's F) splits over
        ``tp``."""
        return self.tp_size > 1 and n % self.tp_size == 0

    @property
    def ep_size(self) -> int:
        return self.axis_size(self.ep_axes)

    @property
    def ep_all_size(self) -> int:
        return self.axis_size(self.ep_all_axes)

    @property
    def decode_fleet(self) -> int:
        """Ranks the decode dispatch spreads its slots over."""
        return self.axis_size(self.decode_axes[0])

    @property
    def decode_axes(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(slot axes, F-slice axes) of the replicated (decode) dispatch:
        ``(ep_all, ())``, or with ``decode_expert_tp`` ``(ep, ep_all minus
        ep)``."""
        if self.decode_expert_tp:
            return self.ep_axes, tuple(a for a in self.ep_all_axes
                                       if a not in self.ep_axes)
        return self.ep_all_axes, ()


def build_slots_of(perm: np.ndarray, n_experts: int, n_slots: int,
                   r_max: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Logical-expert → physical-slot lookup tables from a slot permutation.

    ``perm``: (L, n_slots) int — logical expert held in each physical slot
    (entries ≥ n_experts are phantom padding; entries may repeat = replicas).
    ``r_max`` optionally pins the copy-axis width. Returns ``slots_of``
    (L, E, r_max) int32 (padded with the first copy) and ``n_copies``
    (L, E) int32.
    """
    perm = np.atleast_2d(perm)
    L = perm.shape[0]
    counts = np.zeros((L, n_experts), dtype=np.int32)
    for l in range(L):
        for p in range(n_slots):
            e = perm[l, p]
            if e < n_experts:
                counts[l, e] += 1
    if np.any(counts == 0):
        raise ValueError("some logical expert has no physical slot")
    if r_max is None:
        r_max = int(counts.max())
    elif r_max < int(counts.max()):
        raise ValueError(f"r_max={r_max} < max replica count {counts.max()}")
    slots_of = np.zeros((L, n_experts, r_max), dtype=np.int32)
    fill = np.zeros((L, n_experts), dtype=np.int32)
    for l in range(L):
        for p in range(n_slots):
            e = perm[l, p]
            if e < n_experts:
                slots_of[l, e, fill[l, e]] = p
                fill[l, e] += 1
        for e in range(n_experts):
            slots_of[l, e, counts[l, e]:] = slots_of[l, e, 0]
    return slots_of, counts


def build_copy_cdf(perm: np.ndarray, n_experts: int, n_slots: int,
                   share: Optional[np.ndarray] = None,
                   r_max: Optional[int] = None) -> np.ndarray:
    """Per-(layer, expert) cumulative copy-share table (L, E, r_max) f32
    for weighted dispatch; ``share`` None = uniform over each expert's
    copies. Copies are enumerated in slot order, as :func:`build_slots_of`
    lays them out."""
    perm = np.atleast_2d(perm)
    if perm.shape[1] != n_slots:
        raise ValueError(f"perm has {perm.shape[1]} slots != {n_slots}")
    return copy_share_cdf(perm, n_experts, share=share, r_max=r_max)
