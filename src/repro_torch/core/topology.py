"""Fleet-scale cluster topology: the two-level (node / device) model the
rest of the stack prices communication against.

Every policy before this module treated the cluster as a flat set of G
ranks behind one uniform interconnect. At fleet scale that is wrong by an
order of magnitude: devices within a node talk over ICI, nodes talk over
DCN, and the two bandwidths differ ~8x — exactly the asymmetry the
Expert-Sharding and MoETuner lines of work exploit. :class:`ClusterTopology`
makes the asymmetry a first-class input:

* ``SolveContext.topology`` hands it to placement policies;
* both virtual clocks (``Engine`` and ``EPSimulator``) price a2a,
  migration, and steal-broadcast traffic through it instead of a flat
  ``bytes / ici_bw`` divide;
* :func:`vibe_h_placement` (registered as policy ``vibe_h``) is a
  two-level solver: bin experts across nodes to minimize cross-node (DCN)
  token traffic, then run the existing ``_replicated_solve`` within each
  node against that node's per-rank perf models — straggler latency and
  cross-node bytes co-optimized.

Dispatch locality model (used consistently by :meth:`node_split_loads`
and the simulator's hierarchical a2a clock): tokens originate uniformly
across devices, and a token for expert e sourced on node m goes to a
node-m copy when one exists (shares renormalized within the node);
otherwise it fans out globally in proportion to the copy shares and
crosses the DCN. Compute pricing keeps the solver's *global* shares — a
documented approximation; the communication clock is what models
locality.

All cost methods degenerate exactly to the legacy flat formulas on a
single-node topology with zero link latencies, so pre-existing goldens
stay bit-identical (pinned by ``tests/test_topology.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .placement import (ReplicatedPlacement, _replicated_solve,
                        _replication_degrees, _speed_targets,
                        normalize_slot_budget, vibe_r_placement)

__all__ = [
    "ClusterTopology",
    "parse_topology",
    "vibe_h_placement",
]

#: default ICI:DCN bandwidth ratio when a 2-level topology is built
#: without an explicit DCN number (intra-node fabrics run ~an order of
#: magnitude faster than the inter-node network).
DEFAULT_DCN_RATIO = 8.0


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterTopology:
    """Two-level cluster communication model.

    ``node_of``: (G,) int array — node id of each rank. Node ids must be
        contiguous ``0..K-1``; nodes may be ragged (different sizes), which
        is what lets :meth:`mask` return a survivor topology after a rank
        failure.
    ``ici_bw`` / ``dcn_bw``: per-rank link bandwidth in bytes/s for
        intra-node (ICI) and cross-node (DCN) transfers.
    ``ici_latency`` / ``dcn_latency``: per-transfer hop latency in
        seconds (0 by default, which is also what keeps the flat
        degenerate bit-identical to the legacy pricing).
    """

    node_of: np.ndarray
    ici_bw: float
    dcn_bw: float
    ici_latency: float = 0.0
    dcn_latency: float = 0.0

    def __post_init__(self):
        node_of = np.asarray(self.node_of, dtype=np.int64).ravel()
        if node_of.size < 1:
            raise ValueError("topology needs at least one rank")
        uniq = np.unique(node_of)
        if not np.array_equal(uniq, np.arange(uniq.size)):
            raise ValueError("node ids must be contiguous 0..K-1, got "
                             f"{uniq.tolist()}")
        if self.ici_bw <= 0 or self.dcn_bw <= 0:
            raise ValueError("link bandwidths must be positive")
        if self.ici_latency < 0 or self.dcn_latency < 0:
            raise ValueError("link latencies cannot be negative")
        node_of.setflags(write=False)
        object.__setattr__(self, "node_of", node_of)

    # -- construction -------------------------------------------------------

    @classmethod
    def flat(cls, n_ranks: int, ici_bw: float,
             ici_latency: float = 0.0) -> "ClusterTopology":
        """Single-node topology — the legacy flat-interconnect degenerate."""
        return cls(np.zeros(n_ranks, dtype=np.int64), ici_bw, ici_bw,
                   ici_latency, ici_latency)

    @classmethod
    def uniform(cls, n_nodes: int, devices_per_node: int, ici_bw: float,
                dcn_bw: Optional[float] = None, ici_latency: float = 0.0,
                dcn_latency: float = 0.0) -> "ClusterTopology":
        """``n_nodes`` x ``devices_per_node`` grid; DCN defaults to
        ``ici_bw / DEFAULT_DCN_RATIO``."""
        if n_nodes < 1 or devices_per_node < 1:
            raise ValueError("n_nodes and devices_per_node must be >= 1")
        node_of = np.repeat(np.arange(n_nodes, dtype=np.int64),
                            devices_per_node)
        if dcn_bw is None:
            dcn_bw = ici_bw if n_nodes == 1 else ici_bw / DEFAULT_DCN_RATIO
        return cls(node_of, ici_bw, dcn_bw, ici_latency, dcn_latency)

    # -- shape --------------------------------------------------------------

    @property
    def n_ranks(self) -> int:
        return int(self.node_of.size)

    @property
    def n_nodes(self) -> int:
        return int(self.node_of.max()) + 1

    @property
    def is_flat(self) -> bool:
        return self.n_nodes == 1

    @property
    def node_sizes(self) -> np.ndarray:
        """(K,) device count per node."""
        return np.bincount(self.node_of, minlength=self.n_nodes)

    @property
    def rank_node_sizes(self) -> np.ndarray:
        """(G,) size of the node each rank lives on."""
        return self.node_sizes[self.node_of]

    def ranks_of(self, node: int) -> np.ndarray:
        return np.flatnonzero(self.node_of == node)

    def mask(self, dead_ranks: Sequence[int]) -> "ClusterTopology":
        """Survivor topology after removing ``dead_ranks`` — nodes are
        re-labelled contiguously (a node that loses all its devices
        disappears)."""
        dead = set(int(g) for g in dead_ranks)
        keep = np.array([g for g in range(self.n_ranks) if g not in dead],
                        dtype=np.int64)
        if keep.size == 0:
            raise ValueError("cannot mask every rank")
        nodes = self.node_of[keep]
        _, relabelled = np.unique(nodes, return_inverse=True)
        return ClusterTopology(relabelled.astype(np.int64), self.ici_bw,
                               self.dcn_bw, self.ici_latency,
                               self.dcn_latency)

    # -- pricing ------------------------------------------------------------

    def xfer_cost(self, src_rank: int, dst_rank: int, nbytes: float) -> float:
        """Point-to-point transfer time between two ranks."""
        if src_rank == dst_rank or nbytes <= 0:
            return 0.0
        if self.node_of[src_rank] == self.node_of[dst_rank]:
            return nbytes / self.ici_bw + self.ici_latency
        return nbytes / self.dcn_bw + self.dcn_latency

    def a2a_cost(self, rank_bytes) -> float:
        """All-to-all time for per-rank payloads spread uniformly over all
        G destinations (the self-fraction 1/G is free). Per rank, the
        (D_g - 1)/G fraction rides ICI and the (G - D_g)/G fraction rides
        DCN; the exchange completes when the slowest rank does. Flat
        degenerate: ``rank_bytes * (G-1)/G / ici_bw``."""
        G = self.n_ranks
        rb = np.broadcast_to(np.asarray(rank_bytes, dtype=np.float64), (G,))
        D = self.rank_node_sizes.astype(np.float64)
        per_rank = (rb * (D - 1.0) / G / self.ici_bw
                    + rb * (G - D) / G / self.dcn_bw)
        t = float(per_rank.max())
        if t <= 0.0:
            return 0.0
        hop = self.dcn_latency if self.n_nodes > 1 else self.ici_latency
        return t + hop

    def cross_fraction(self) -> float:
        """Probability a uniformly random (src, dst) pair of *distinct*
        ranks crosses the DCN; 0 for flat or single-rank topologies."""
        G = float(self.n_ranks)
        if G <= 1.0:
            return 0.0
        sz = self.node_sizes.astype(np.float64)
        return 1.0 - float((sz * (sz - 1.0)).sum()) / (G * (G - 1.0))

    def migration_cost(self, nbytes: float, parallel_links: int = 1) -> float:
        """Time to move ``nbytes`` of expert weights between uniformly
        random rank pairs, striped over ``parallel_links`` concurrent
        links. The engine serializes migrations on one link
        (``parallel_links=1`` — flat degenerate ``nbytes / ici_bw``); the
        simulator models G concurrent links (flat degenerate
        ``nbytes / (G * ici_bw)``)."""
        if nbytes <= 0:
            return 0.0
        f_x = self.cross_fraction()
        per = nbytes / max(int(parallel_links), 1)
        cost = per * ((1.0 - f_x) / self.ici_bw + f_x / self.dcn_bw)
        return float(cost + (1.0 - f_x) * self.ici_latency
                     + f_x * self.dcn_latency)

    def broadcast_cost(self, nbytes: float) -> float:
        """Time to broadcast ``nbytes`` (share tables) to every rank —
        bottlenecked by the slowest link class present."""
        if nbytes <= 0:
            return 0.0
        if self.is_flat:
            return nbytes / self.ici_bw + self.ici_latency
        return (nbytes / min(self.ici_bw, self.dcn_bw)
                + max(self.ici_latency, self.dcn_latency))

    # -- locality accounting ------------------------------------------------

    def node_split_loads(self, placement,
                         loads: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Split per-rank token arrivals into intra-node and cross-node
        components under the node-preferring dispatch model.

        ``placement`` is a :class:`ReplicatedPlacement` (singleton
        placements are lifted automatically); ``loads`` is the (L, E)
        per-expert token matrix. Returns ``(local_in, cross_in)`` — two
        (L, G) arrays of tokens arriving at each rank from its own node
        vs over the DCN. ``local_in + cross_in`` sums to ``loads`` per
        layer (conservation), and on a flat topology ``cross_in`` is zero
        and ``local_in`` equals the placement's ``rank_loads``."""
        if not hasattr(placement, "slot_expert"):
            placement = ReplicatedPlacement.from_singleton(placement)
        G, K = self.n_ranks, self.n_nodes
        if placement.n_ranks != G:
            raise ValueError(f"placement has {placement.n_ranks} ranks, "
                             f"topology has {G}")
        se, sh = placement.slot_expert, placement.share
        L, S = se.shape
        E = placement.n_experts
        spr = S // G
        w = np.atleast_2d(np.asarray(loads, dtype=np.float64))
        node_of_slot = self.node_of[np.repeat(np.arange(G), spr)]    # (S,)

        # node shares sigma[l, e, m] = total copy share of e on node m
        sigma = np.zeros((L, E + 1, K))
        np.add.at(sigma,
                  (np.repeat(np.arange(L), S), se.ravel(),
                   np.tile(node_of_slot, L)), sh.ravel())
        sigma = sigma[:, :E, :]

        frac = self.node_sizes.astype(np.float64) / G                # (K,)
        covered = sigma > 1e-12
        uncov = ((~covered) * frac[None, None, :]).sum(-1)           # (L, E)

        lI = np.arange(L)[:, None]
        valid = se < E
        e_safe = np.minimum(se, E - 1)
        sig_slot = sigma[lI, e_safe, node_of_slot[None, :]]          # (L, S)
        w_slot = w[lI, e_safe]
        local = np.where(
            valid & (sig_slot > 1e-12),
            w_slot * frac[node_of_slot][None, :] * sh
            / np.maximum(sig_slot, 1e-12), 0.0)
        cross = np.where(valid, w_slot * uncov[lI, e_safe] * sh, 0.0)
        return (local.reshape(L, G, spr).sum(-1),
                cross.reshape(L, G, spr).sum(-1))


def parse_topology(spec: str, ici_bw: float,
                   dcn_bw: Optional[float] = None) -> ClusterTopology:
    """Parse a CLI topology spec: ``"2x4"`` → 2 nodes x 4 devices,
    ``"8"`` → flat 8 ranks. DCN bandwidth defaults to
    ``ici_bw / DEFAULT_DCN_RATIO`` for multi-node specs."""
    s = spec.strip().lower()
    if "x" in s:
        try:
            n_nodes, per_node = (int(p) for p in s.split("x"))
        except ValueError:
            raise ValueError(
                f"bad topology spec {spec!r} — want 'KxD'") from None
        return ClusterTopology.uniform(n_nodes, per_node, ici_bw, dcn_bw)
    try:
        n_ranks = int(s)
    except ValueError:
        raise ValueError(
            f"bad topology spec {spec!r} — want 'KxD' or 'G'") from None
    return ClusterTopology.flat(n_ranks, ici_bw)


# ---------------------------------------------------------------------------
# vibe_h: two-level node-aware hierarchical solver
# ---------------------------------------------------------------------------

def _bin_experts_to_nodes(w_l: np.ndarray, node_share: np.ndarray,
                          node_cap: np.ndarray, spare: int) -> np.ndarray:
    """Phase A of vibe_h for one layer: assign each expert to >= 1 node,
    spending the spare slots on cross-node replicas of the hottest experts
    (a replica on every sourcing node zeroes that expert's DCN traffic).

    Returns a boolean (E, K) coverage matrix. Greedy: per-copy loads in
    descending order, each copy to the node farthest below its
    speed-proportional token target, honoring per-node slot capacity and
    one-copy-per-node dedup.
    """
    E, K = w_l.size, node_cap.size
    n_extra = min(spare, E * (K - 1))
    deg = _replication_degrees(w_l[None, :], n_extra, max_copies=K)[0]
    order = np.argsort(-(w_l / deg), kind="stable")

    tau = node_share / node_share.sum() * w_l.sum()
    load = np.zeros(K)
    count = np.zeros(K, dtype=np.int64)
    cover = np.zeros((E, K), dtype=bool)
    for e in order:
        q = w_l[e] / deg[e]
        for _ in range(int(deg[e])):
            free = count < node_cap
            cand = np.flatnonzero(free & ~cover[e])
            if cand.size == 0:
                if cover[e].any():
                    break                      # trim the extra copy
                cand = np.flatnonzero(free)    # first copy must land
            m = cand[np.argmax((tau - load)[cand])]
            cover[e, m] = True
            count[m] += 1
            load[m] += q
    # a node with zero experts would break the per-node sub-solve: hand it
    # a replica of the hottest expert it doesn't already hold
    for m in np.flatnonzero(count == 0):
        e = int(np.argmax(np.where(cover[:, m], -np.inf, w_l)))
        cover[e, m] = True
        count[m] += 1
    return cover


def vibe_h_placement(
    w: np.ndarray,                 # (L, E) activation matrix
    perf_models,                   # per-rank perf models, len G
    topology: Optional[ClusterTopology] = None,
    slots_per_rank=None,           # None | int | (G,) per-rank budgets
    n_ref_mode: str = "rank",
) -> ReplicatedPlacement:
    """Two-level node-aware ViBE solve (policy ``vibe_h``).

    Per layer, phase A bins experts across nodes to minimize cross-node
    token traffic (node-copy replication of that layer's hot experts,
    speed-proportional node targets — binning is per-layer because expert
    hotness is: an aggregate-hot expert can be cold in the very layer
    where another is melting its node's DCN link); phase B runs the full
    ViBE-R ``_replicated_solve`` *within* each node against that node's
    per-rank perf models and the node's share of each resident expert's
    traffic. The per-node placements are stitched back into one global
    rank-major slot table whose copy shares are
    ``sigma(e, node) * local_share`` — they still sum to 1 per
    (layer, expert), so every downstream consumer (dispatch CDFs, clocks,
    steal) works unchanged.

    On a flat (or absent) topology this delegates to
    :func:`vibe_r_placement` exactly — there is no node structure to
    exploit, and the delegation keeps topology-free call sites
    bit-identical.
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    L, E = w.shape
    G = len(perf_models)
    if topology is None or topology.is_flat:
        return vibe_r_placement(w, perf_models, slots_per_rank=slots_per_rank,
                                n_ref_mode=n_ref_mode)
    if topology.n_ranks != G:
        raise ValueError(f"topology has {topology.n_ranks} ranks but "
                         f"{G} perf models were given")
    budget = normalize_slot_budget(slots_per_rank, E, G)
    s_max = int(budget.max())
    spare = int(budget.sum()) - E
    speeds, _ = _speed_targets(w, perf_models, n_ref_mode)       # (L, G)

    K = topology.n_nodes
    node_ranks: List[np.ndarray] = [topology.ranks_of(m) for m in range(K)]
    node_speed = np.stack([speeds[:, r].sum(1) for r in node_ranks],
                          axis=1)                                 # (L, K)
    node_cap = np.array([int(budget[r].sum()) for r in node_ranks])

    slot_expert = np.full((L, G * s_max), E, dtype=np.int32)
    share = np.zeros((L, G * s_max))
    for l in range(L):
        cover = _bin_experts_to_nodes(w[l], node_speed[l], node_cap, spare)
        # node shares: split each expert's traffic over its covering
        # nodes in proportion to aggregate node speed
        sig = cover * node_speed[l][None, :]                      # (E, K)
        sig = sig / np.maximum(sig.sum(-1, keepdims=True), 1e-12)
        for m in range(K):
            em = np.flatnonzero(cover[:, m])
            ranks = node_ranks[m]
            Em = em.size
            pm = [perf_models[g] for g in ranks]
            # a rank budget above the node's expert count is unusable
            # slots — clamp (the global table pads the tail with phantoms)
            bm = np.minimum(budget[ranks], Em)
            sig_m = sig[em, m]                                    # (Em,)
            w_m = w[l:l + 1, em] * sig_m[None, :]
            sp_m, tg_m = _speed_targets(w_m, pm, n_ref_mode)
            sub = _replicated_solve(w_m, sp_m, tg_m, ranks.size, bm,
                                    perf_models=pm)
            sm = sub.slots_per_rank
            for j, g in enumerate(ranks):
                le = sub.slot_expert[0, j * sm:(j + 1) * sm]      # (sm,)
                ls = sub.share[0, j * sm:(j + 1) * sm]
                real = le < Em
                le_safe = np.minimum(le, Em - 1)
                lo = g * s_max
                slot_expert[l, lo:lo + sm] = np.where(real, em[le_safe], E)
                share[l, lo:lo + sm] = np.where(real,
                                                sig_m[le_safe] * ls, 0.0)
    return ReplicatedPlacement(slot_expert, share, G, E)
