"""What a call costs a rank: FLOPs, memory traffic, collectives by kind,
kernel calls and peak live bytes, counted as its operations run.

The counterpart of ``repro.launch.hlo_analysis`` (``parse_hlo``,
``src/repro/launch/hlo_analysis.py:322``). Eager PyTorch has no HLO to
read, so :func:`count_costs` counts the tensor operations as they run
(a ``TorchDispatchMode``), on any device: on ``meta`` (the dry run,
:mod:`repro_torch.launch.dryrun`) nothing is computed, and the same
operations are counted as on the card. Every iteration of a Python loop
(the block loop, the flash and loss chunks) is counted as it runs, which
is what ``parse_hlo``'s trip-count correction reconstructs from a
``while``'s condition. Autograd's engine runs the backward with the
forward thread's dispatch modes, so a ``backward()`` inside the context
is counted too. What is counted, per rank:

* **FLOPs** of the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``dot``, the convolutions): ``2 · result elements
  · contracted elements``, as ``parse_hlo`` counts a ``dot``; elementwise
  operations count none, as there. A hand-written kernel's call adds the
  operations of its entry (:mod:`repro_torch.kernels.costs`).
* **Memory traffic**: each operation's operand and result bytes (an
  operand read through a broadcast no more than its storage). Views
  (results that alias an operand, by the operation's schema) move
  nothing, as ``parse_hlo`` leaves out broadcast, reshape, transpose and
  slice; an in-place operation counts its operands; an ``empty`` moves
  nothing. Eager elementwise chains read and write every intermediate,
  which XLA's fusions do not: this is a true count of what the port does,
  and more than ``parse_hlo`` counts for the same model.
* **Collectives by kind**, under ``parse_hlo``'s names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``; ``gather`` and
  ``broadcast`` besides): the operand bytes a call sends, per rank, as
  ``parse_hlo`` counts them and as ``collectives.clock`` counts the same
  calls; the traffic adds operand and result bytes.
* **Kernel calls** by name, with their entries' FLOPs and bytes.
* **Peak live bytes**: every storage an operation allocates, from its
  allocation until it is freed (``weakref.finalize`` on the storage;
  views share it and count once), each rounded up to the CUDA caching
  allocator's 512-byte block. ``argument_bytes`` are the storages of the
  arguments given (as they are, not rounded), ``peak_bytes`` the most
  allocated at once above them,
  ``exit_bytes`` what is still allocated at exit (the results and what
  they hold), ``peak_live`` the largest storages live at the peak (bytes,
  the operation that allocated each, its shape): what sets the peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import math
import weakref
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs as kernel_costs
from repro_torch.tree import leaves

__all__ = ["Costs", "count_costs", "COLLECTIVE_KINDS", "BLOCK"]

#: the CUDA caching allocator's block: every allocation is a multiple
BLOCK = 512
#: storages listed in ``Costs.peak_live``
PEAK_TOP = 12

#: c10d operation → the kind ``parse_hlo`` names it by
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "gather_": "gather", "broadcast_": "broadcast", "scatter_": "scatter"}
_INPUTS = ("tensors", "input_tensors", "input_tensor", "input", "inputs")
_OUTPUTS = ("output_tensors", "output_tensor", "output", "outputs")
_NO_TRAFFIC = {"aten::empty", "aten::empty_like", "aten::empty_strided",
               "aten::new_empty", "aten::new_empty_strided",
               "aten::empty_permuted"}


@dataclasses.dataclass
class Costs:
    """One rank's counts over a :func:`count_costs` block."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_calls: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: traffic and calls by operation (``aten::mm``, a kernel's name):
    #: where two counts of one call differ, this says which operation
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    exit_bytes: int = 0
    peak_live: List[Tuple[int, str, Tuple[int, ...]]] = dataclasses.field(
        default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _read_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes, no more than its storage's (a broadcast operand
    is read once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _blocks(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _product_flops(name: str, args, out) -> float:
    """``2 · result elements · contracted elements`` of a matrix product,
    0 for any other operation."""
    if name in ("aten::mm", "aten::bmm", "aten::mv", "aten::dot"):
        a = args[0]
    elif name in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        a = args[1]
    elif name == "aten::convolution":
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    elif name == "aten::convolution_backward":
        grad_out, _, w = args[:3]
        mask = args[-1]
        per = 2.0 * grad_out.numel() * math.prod(w.shape[1:])
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


class _Counter(TorchDispatchMode):
    """Counts every operation into ``costs`` and keeps the live storages."""

    def __init__(self, costs: Costs, known: set):
        super().__init__()
        self.costs = costs
        self.known = known            # the arguments' storages
        self.live: Dict[int, Tuple[int, str, Tuple[int, ...]]] = {}
        self.now = 0
        self.finalizers: List[weakref.finalize] = []

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.costs
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1
        c.kernel_flops[name] = c.kernel_flops.get(name, 0.0) + flops
        c.kernel_bytes[name] = c.kernel_bytes.get(name, 0.0) + nbytes
        c.flops += flops
        self._traffic(name, nbytes)

    def _traffic(self, name: str, nbytes: float) -> None:
        c = self.costs
        c.bytes_accessed += nbytes
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + nbytes
        c.calls_by_op[name] = c.calls_by_op.get(name, 0) + 1

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, (0,))[0]

    def _track(self, name: str, out, operands) -> None:
        """Count the storages of ``out`` that no operand holds and that
        were not counted before: the operation allocated them."""
        held = {t.untyped_storage()._cdata for t in _tensors(operands)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.known or key in held:
                continue
            size = _blocks(st.nbytes())
            self.live[key] = (size, name, tuple(t.shape))
            self.now += size
            self.finalizers.append(weakref.finalize(st, self._free, key))
        if self.now > self.costs.peak_bytes:
            self.costs.peak_bytes = self.now
            self.costs.peak_live = heapq.nlargest(PEAK_TOP,
                                                  self.live.values())

    def _collective(self, func, kind, args, kwargs) -> None:
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        sent = sum(_read_bytes(t) for k in _INPUTS if k in named
                   for t in _tensors(named[k]))
        got = sum(_read_bytes(t) for k in _OUTPUTS if k in named
                  for t in _tensors(named[k]))
        if "tensors" in named:                # in place: written back
            got = sent
        c = self.costs
        c.collective_bytes += sent
        c.collective_by_kind[kind] = c.collective_by_kind.get(kind, 0.0) \
            + sent
        c.collective_calls[kind] = c.collective_calls.get(kind, 0) + 1
        self._traffic(func._schema.name, sent + got)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        name = schema.name
        operands = list(args) + list(kwargs.values())
        if name.startswith("c10d::"):
            kind = COLLECTIVE_KINDS.get(name[len("c10d::"):])
            if kind is not None:
                self._collective(func, kind, args, kwargs)
            self._track(name, out, operands)
            return out
        self.costs.flops += _product_flops(name, args, out)
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if not view and name not in _NO_TRAFFIC:
            nbytes = sum(_read_bytes(t) for t in _tensors(operands))
            if not schema.is_mutable:          # in place: operands only
                nbytes += sum(_read_bytes(t) for t in _tensors(out))
            self._traffic(name, nbytes)
        self._track(name, out, operands)
        return out


@contextlib.contextmanager
def count_costs(*arguments) -> Iterator[Costs]:
    """Count what the block costs this rank (see the module's docstring)
    into the :class:`Costs` it yields; ``arguments`` (trees of tensors)
    are what the block is given: their storages are ``argument_bytes``
    and are not counted as allocated inside. The counts are final when
    the block exits."""
    seen: Dict[int, int] = {}
    for t in leaves(list(arguments)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    costs = Costs(argument_bytes=sum(seen.values()))
    counter = _Counter(costs, set(seen))
    kernel_costs.listen(counter.kernel)
    try:
        with counter:
            yield costs
    finally:
        kernel_costs.unlisten(counter.kernel)
        costs.exit_bytes = counter.now
        for f in counter.finalizers:
            f.detach()
