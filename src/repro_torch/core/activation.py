"""Expert activation profiling (paper §4.2.2, Alg 1 Phase 1).

MoE routing is input-dependent and layer-specific, but activation patterns
are empirically stable for a given workload. ViBE profiles expert activation
over a representative input set, producing the activation matrix

    W ∈ R^{L×E},   w_e^{(l)} = relative token load of expert e at layer l.

The profiler consumes per-step routing tallies — available for free from the
router's top-k output (``models/moe.py`` returns them as an aux output) — and
maintains both the cumulative matrix (for initial placement) and a rolling
window (for the drift detector / recalibration statistics).
"""

from __future__ import annotations

import collections
from typing import Deque, Optional

import numpy as np

__all__ = ["ActivationProfiler", "routing_tally"]


def routing_tally(topk_idx: np.ndarray, n_experts: int,
                  weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-expert token tally for one layer from top-k indices.

    ``topk_idx``: (T, K) int routing decisions (or any shape; flattened).
    ``weights``:  optional matching router gate weights; when given the tally
    is gate-weighted (fractional compute per token-expert pair).
    """
    idx = np.asarray(topk_idx).reshape(-1)
    if weights is None:
        return np.bincount(idx, minlength=n_experts).astype(np.float64)
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    return np.bincount(idx, weights=w, minlength=n_experts)


class ActivationProfiler:
    """Accumulates routing statistics into the activation matrix W.

    * ``update(step_counts)``     — add one forward pass's (L, E) tallies.
    * ``matrix()``                — cumulative mean W (L, E).
    * ``window_matrix()``         — rolling-window mean (drift statistics).
    * ``mean_tokens()``           — mean batch token count (stress signal).
    """

    def __init__(self, n_layers: int, n_experts: int, window: int = 100):
        self.L, self.E = int(n_layers), int(n_experts)
        self._sum = np.zeros((self.L, self.E), dtype=np.float64)
        self._count = 0
        self._win: Deque[np.ndarray] = collections.deque(maxlen=window)
        self._tok_win: Deque[float] = collections.deque(maxlen=window)

    def update(self, step_counts: np.ndarray) -> None:
        c = np.asarray(step_counts, dtype=np.float64)
        if c.shape != (self.L, self.E):
            raise ValueError(f"expected ({self.L},{self.E}), got {c.shape}")
        self._sum += c
        self._count += 1
        self._win.append(c)
        self._tok_win.append(float(c[0].sum()) if self.L else 0.0)

    @property
    def n_samples(self) -> int:
        return self._count

    def matrix(self) -> np.ndarray:
        """Cumulative mean activation matrix W (L, E)."""
        if self._count == 0:
            return np.full((self.L, self.E), 1.0 / max(self.E, 1))
        return self._sum / self._count

    def window_matrix(self) -> np.ndarray:
        if not self._win:
            return self.matrix()
        return np.mean(np.stack(self._win), axis=0)

    def mean_tokens(self) -> float:
        return float(np.mean(self._tok_win)) if self._tok_win else 0.0

    def reset(self) -> None:
        self._sum[:] = 0.0
        self._count = 0
        self._win.clear()
        self._tok_win.clear()
