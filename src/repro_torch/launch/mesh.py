"""Named rank grids on ``torch.distributed``.

The counterpart of ``repro.launch.mesh.make_mesh(shape, axes)``: where the
reference names the axes of a device mesh, :func:`make_mesh` names the axes
of a grid of ranks of an initialised default process group, e.g. ``(2, 4)``
over ``("data", "model")``. Rank ``r`` sits at the row-major coordinates of
``r`` in ``shape``. For every combination of axes it builds the subgroup of
the ranks that differ only along those axes, so a collective "over the
``model`` axis" or "over ``("data", "model")``" is one call on one group.
A group's ranks are ordered row-major over its axes in grid order (the
order ``torch.distributed`` gives a group's ranks, by global rank), which
is the order the reference's ``axis_index`` walks ``ep_all``.

The backend is the caller's choice, made in ``init_process_group``:
``gloo`` on the CPU, ``nccl`` where each rank has its own card, and
``gloo`` on CUDA tensors for several ranks sharing one card (NCCL refuses
two ranks on one device). :func:`run_ranks` starts such a group of
processes on one host and collects what each returns.

:func:`fake_group` starts a default group of any size in which this
process plays one rank and the collectives do nothing (PyTorch's ``fake``
backend): the dry run (:mod:`repro_torch.launch.dryrun`) traces one rank
of the production grid (:func:`make_production_mesh`) with it on the
``meta`` device. A process has one default group, so a grid of another
size runs in a process of its own.
"""

from __future__ import annotations

import datetime
import gc
import itertools
import math
import socket
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Grid", "make_mesh", "make_production_mesh", "fake_group",
           "run_ranks", "free_port"]

Axes = Union[str, Sequence[str]]


class Grid:
    """A named grid of the default group's ranks and its subgroups.

    ``group(axes)`` is the subgroup over ``axes`` that holds this rank, or
    ``None`` when it has one rank (a collective over it is the identity);
    ``index(axes)`` is this rank's place in it; ``axis_size(axes)`` the
    product of the sizes of those of ``axes`` that the grid has (1 for
    none, as the reference's ``ShardingRules.axis_size``)."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 rank: int, groups: Dict[Tuple[str, ...], Any]):
        self.shape = shape
        self.axes = axes
        self.rank = rank
        self.coords = dict(zip(axes, (int(c) for c in
                                      np.unravel_index(rank, shape))))
        self._groups = groups

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in zip(self.axes, self.shape))
        return f"Grid({dims}; rank {self.rank})"

    def canon(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` that the grid has, in grid order, each once."""
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.axes if a in names)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[self.axes.index(a)]
                         for a in self.canon(axes))

    def index(self, axes: Axes, coords: Optional[Dict[str, int]] = None
              ) -> int:
        """This rank's (or the rank at ``coords``') index in the group over
        ``axes``: row-major over them in grid order."""
        coords = self.coords if coords is None else coords
        i = 0
        for a in self.canon(axes):
            i = i * self.shape[self.axes.index(a)] + coords[a]
        return i

    def members(self, axes: Axes) -> List[Dict[str, int]]:
        """The coordinates of the group over ``axes``, in group order."""
        axes = self.canon(axes)
        sizes = [self.shape[self.axes.index(a)] for a in axes]
        return [dict(self.coords, **dict(zip(axes, c)))
                for c in itertools.product(*(range(n) for n in sizes))]

    def group(self, axes: Axes):
        axes = self.canon(axes)
        if self.axis_size(axes) == 1:
            return None
        return self._groups[axes]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Grid:
    """The grid ``shape`` over ``axes`` on the default process group, whose
    size must be ``prod(shape)``. Every rank must call it, in the same
    order as every other collective: building a subgroup is collective."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised; "
                           "call init_process_group with the backend first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_mesh: {world} ranks for a grid of {shape}")
    rank = dist.get_rank()
    ranks = np.arange(world).reshape(shape)
    groups: Dict[Tuple[str, ...], Any] = {}
    for n in range(1, len(axes) + 1):
        for dims in itertools.combinations(range(len(axes)), n):
            names = tuple(axes[d] for d in dims)
            if math.prod(shape[d] for d in dims) == 1:
                continue
            if n == len(axes):
                groups[names] = dist.group.WORLD
                continue
            rest = [d for d in range(len(axes)) if d not in dims]
            cosets = np.moveaxis(ranks, rest, list(range(len(rest))))
            cosets = cosets.reshape(-1, math.prod(shape[d] for d in dims))
            for members in cosets:
                g = dist.new_group(sorted(int(r) for r in members))
                if rank in members:
                    groups[names] = g
    return Grid(shape, axes, rank, groups)


def make_production_mesh(multi_pod: bool = False) -> Grid:
    """The production grid on the default group, as
    ``src/repro/launch/mesh.py:20-38`` builds its mesh: 16 x 16 over
    ``("data", "model")`` (256 ranks) or 2 x 16 x 16 over ``("pod",
    "data", "model")`` (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def fake_group(world: int, rank: int = 0) -> None:
    """Start this process's default group as rank ``rank`` of ``world``
    on the ``fake`` backend, whose collectives return at once and move
    nothing (``torch.testing._internal.distributed.fake_pg``, a private
    module: an import error here means the installed torch lacks it). A
    group that is running already is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, backend: str, port: int,
               timeout_s: float, fn: Callable, box: list, results) -> None:
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            # the arguments leave the box, so that they die with this
            # call: a CUDA tensor shared by the parent is released to it
            # only when the last reference here goes (a rank exits
            # without running destructors)
            out = fn(rank, *box.pop())
            gc.collect()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                     # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *, backend: str = "gloo",
              args: Iterable = (), timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in a
    process group over ``backend`` on localhost; return each rank's
    result, in rank order. ``fn`` must be importable (the processes start
    from a fresh interpreter) and its result picklable. A failed rank
    raises here with its traceback, the other processes are stopped, and
    a collective left waiting gives up after ``timeout_s`` (the whole run
    after twice that). CUDA tensors among ``args`` reach the ranks through
    CUDA IPC, and the ranks release them when ``fn`` returns; the caller
    frees its side with ``torch.cuda.ipc_collect()`` once it drops them."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, port, timeout_s, fn,
                               [tuple(args)], results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failed: Optional[str] = None
    deadline = time.monotonic() + 2 * timeout_s
    try:
        while len(out) < world and failed is None:
            if results.empty():
                if not any(p.is_alive() for p in procs):
                    if results.empty():       # a result put just before exit
                        failed = "a rank exited without a result"
                elif time.monotonic() > deadline:
                    failed = f"no result within {2 * timeout_s:.0f} s"
                else:
                    procs[0].join(0.05)
                continue
            rank, ok, value = results.get()
            if ok:
                out[rank] = value
            else:
                failed = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.terminate()
            p.join(timeout_s)
    if failed is not None:
        raise RuntimeError(f"run_ranks: {failed}")
    return [out[r] for r in range(world)]
