"""Cost entries of the kernel calls, for the counters that listen.

Each kernel wrapper reports one entry a call — the kernel's name, the
floating-point operations of its matrix products and the bytes it moves —
where it allocates its outputs, on the card and on the ``meta`` device
alike (:mod:`.ops`). An entry is a function of the arguments' shapes only:
the work the launch grid covers, each operand read once, each output and
each scratch written once (a scratch the kernel reads back, once more).
So a call on the card and the same call traced on ``meta`` report the same
entry. For the ragged FFN kernels that is the static buffer of
``ragged_n_tiles(A, n_slots, bm) · bm`` rows, an upper bound on the rows
the plan fills; PERF.md's bound reads the real rows from the data and is
not this entry. A CPU tensor takes the plain version, whose tensor
operations a counter sees itself, and reports no entry.

:func:`repro_torch.launch.cost_analysis.count_costs` listens while it
counts; nothing listens otherwise, and a report is then one empty loop.
"""

from __future__ import annotations

from typing import Callable, List

import torch

__all__ = ["listen", "unlisten", "listening", "report", "tensor_bytes"]

_SINKS: List[Callable[[str, float, float], None]] = []


def listen(sink: Callable[[str, float, float], None]) -> None:
    """Send every entry from now on to ``sink(name, flops, bytes)``."""
    _SINKS.append(sink)


def unlisten(sink) -> None:
    _SINKS.remove(sink)


def listening() -> bool:
    """Whether a sink listens: a caller may skip working out an entry."""
    return bool(_SINKS)


def report(name: str, flops: float, nbytes: float) -> None:
    for sink in _SINKS:
        sink(name, flops, nbytes)


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))
