"""The collectives of the expert-parallel MoE bodies and of the tensor-
and sequence-parallel dense layers, for autograd.

Each rank of a group runs the same program on its own share of the work:
its own rows of the batch and, under sequence parallelism, of the
sequence. The backward of each collective is chosen for the convention
that after ``loss.backward()`` the gradient a rank holds of a tensor it
holds *whole* is the whole gradient, and of a *sliced* tensor the rank's
slice of it. That is what ``jax.grad`` of the reference's mesh run gives,
and a collective whose backward is another all-reduce (as in
``torch.distributed.nn``) would give ``world`` times that.

* :func:`all_to_all` — equal splits on dim 0; its backward is the mirror
  exchange.
* :func:`exchange` — rows of dim 0 to each rank in counts of their own
  (the weights' migration between ranks), outside autograd.
* :func:`sum_partials` — the ``psum`` of rank partials into a replicated
  output (a row-parallel product's at decode, the vocab-parallel lookup's
  without sequence parallelism); its backward passes the (replicated)
  gradient to each partial.
* :func:`max_over` — the ``pmax`` of a tensor outside autograd (decode's
  merge of the ranks' softmax stats, the vocab-parallel loss's shift).
* :func:`mean_over` — the ``pmean`` of ``mean_prob`` and of the loss over
  the ranks' rows; backward ``g / n``.
* :func:`gather_shards` — the FSDP ``all_gather`` of weights along a dim
  (backward: the reduce-scatter of the gathered weight's gradient over
  the ranks that use it on different rows, the rank's own slice over
  those that do the same work with it), and the gather of the last rows
  and of the logits.
* :func:`gather_to` — a tensor from every rank of a group to one rank,
  outside autograd (a checkpoint's save from a grid, on the host).
* :func:`gather_seq` / :func:`scatter_partials` — Megatron-SP's pair. The
  first gathers the ranks' rows along the sequence before a column-
  parallel product (backward: the reduce-scatter of the gradient, since
  each rank's downstream work touches every row); the second reduce-
  scatters a row-parallel product's partials to the rank's rows
  (backward: the all-gather of the gradient).
* :func:`replicate` — a tensor held whole and read by ranks that work on
  different rows or shares (a leaf's gradient summed over the ranks that
  see different rows, a column-parallel product's input at decode, the
  experts' router and tokens): identity forward, the ranks' gradient
  contributions summed backward (the transpose of the reference's
  implicit broadcast of a replicated ``shard_map`` input; for the leaves,
  DDP's gradient all-reduce, placed where ``jax.grad`` puts it).
* :func:`take_block` / :func:`gather_blocks` — a member's ``(b, s)`` block
  of a ``(B, S, ...)`` tensor held whole, and back. The MoE layer uses
  them to move between the rank's rows and the layout a dispatch body
  needs where the two differ: the a2a block where the expert-parallel
  axes are not the sequence-parallel ones (hand-built rules), or where
  the batch splits and the sequence does not; the replicated bodies'
  whole batch.

gloo reduces in its own order, and ``reduce_scatter`` takes CUDA tensors
on the card (the same call as :func:`gather_shards`' backward), so
:func:`scatter_partials` is one ``reduce_scatter``.

A ``group`` of ``None`` is a one-rank group: every function is then the
identity (no call is made). :data:`clock` times the exchanges on the host
when it is switched on (each timed call synchronises the card first and
after); it is off unless a caller sets ``clock.enabled``.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "exchange", "sum_partials", "max_over", "mean_over",
           "gather_shards", "gather_to", "gather_seq", "scatter_partials",
           "replicate", "take_block", "gather_blocks", "all_reduce_",
           "clock", "ExchangeClock"]


class ExchangeClock:
    """Host seconds, calls and operand bytes of the collectives while
    ``enabled``; ``by_kind`` holds each kind's ``[calls, bytes]`` under
    ``parse_hlo``'s names (``all-reduce``, ``all-to-all``, ...), as
    ``launch.cost_analysis`` counts them."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.seconds = 0.0
        self.calls = 0
        self.bytes = 0
        self.by_kind = {}

    def run(self, fn, t: torch.Tensor, kind: str):
        if not self.enabled:
            return fn()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0
        n = t.numel() * t.element_size()
        self.calls += 1
        self.bytes += n
        calls, nbytes = self.by_kind.get(kind, (0, 0))
        self.by_kind[kind] = [calls + 1, nbytes + n]
        return out


clock = ExchangeClock()


def _n(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` of a tensor outside autograd (tallies)."""
    if group is not None:
        clock.run(lambda: dist.all_reduce(t, group=group), t,
                  "all-reduce")
    return t


def _released(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t``, the result of a collective, to hand to autograd as
    a gradient. gloo's worker thread may hold ``t`` for a moment after the
    call returns, and autograd takes a leaf's gradient as its ``grad`` only
    when nothing else holds it (else it copies it): the view is held by
    autograd alone, so the leaf takes it, on every run alike."""
    return t.view_as(t)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    clock.run(lambda: dist.all_to_all_single(out, x, group=group), x,
              "all-to-all")
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rows ``[r n/w, (r + 1) n/w)`` of ``x`` go to rank ``r`` of the
    group; the result holds rank ``j``'s rows for this rank at block
    ``j`` (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, group)
    return _a2a(x, group)


def exchange(x: torch.Tensor, group, send_counts: Sequence[int],
             recv_counts: Sequence[int]) -> torch.Tensor:
    """Rows of ``x`` to the ranks of ``group``: its first ``send_counts[0]``
    rows to rank 0, the next ``send_counts[1]`` to rank 1, and so on; the
    result holds the rows each rank sent here, in group order
    (``recv_counts[j]`` from rank ``j``). Outside autograd. Every rank of
    the group calls it, and each pair's counts agree."""
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((int(sum(recv_counts)),) + tuple(x.shape[1:]))
    clock.run(lambda: dist.all_to_all_single(
        out, x, output_split_sizes=[int(n) for n in recv_counts],
        input_split_sizes=[int(n) for n in send_counts], group=group), x,
        "all-to-all")
    return out


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _SumPartials.apply(x, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group`` of a tensor outside autograd,
    as a new tensor. It has no gradient to give: a tensor that requires
    one is refused."""
    if x.requires_grad:
        raise ValueError("max_over: the input requires grad; pass a "
                         "detached tensor (the max is a shift, not a term)")
    if group is None:
        return x
    t = x.clone()
    clock.run(lambda: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group),
              t, "all-reduce")
    return t


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _n(group)
        return all_reduce_(x.clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _MeanOver.apply(x, group)


def _gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_n(group))]
    clock.run(lambda: dist.all_gather(parts, x, group=group), x,
              "all-gather")
    return parts


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        chunks = [c.contiguous() for c in g.chunk(_n(ctx.group), ctx.dim)]
        summed, group = ctx.summed, ctx.group
        if isinstance(summed, tuple):
            group, members = summed
            chunks = [chunks[i] for i in members]
            if group is None:
                return chunks[0], None, None, None
        elif not summed:
            return chunks[dist.get_rank(group)], None, None, None
        out = torch.empty_like(chunks[0])
        clock.run(lambda: dist.reduce_scatter(out, chunks, group=group),
                  g, "reduce-scatter")
        return _released(out), None, None, None


def gather_shards(x: torch.Tensor, group, dim: int,
                  summed=True) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in group
    order (``lax.all_gather(..., axis=dim, tiled=True)``). ``summed`` says
    which ranks of the group use the whole tensor on different work (the
    a2a bodies' tokens, other rows of the batch), whose gradients are
    summed, and which do the same work as this rank, whose gradients are
    the same and counted once:

    * ``True``: every rank works apart; the gradient is the reduce-scatter
      of theirs;
    * ``False``: every rank does the same work; each keeps its own slice;
    * ``(sum_group, members)``: the ranks of ``sum_group`` (a subgroup of
      ``group`` that holds this rank, or ``None`` for this rank alone)
      work apart and the rest of ``group`` does their work again:
      ``members`` are the shards' indices in ``group`` that the members of
      ``sum_group`` hold, in ``sum_group``'s order. The gradient is
      reduce-scattered over ``sum_group``, of the slices at ``members``:
      this rank's slice summed over the ranks that work apart, once
      each (an FSDP group wider than the axes that split the rows)."""
    if group is None:
        return x
    return _GatherShards.apply(x, group, dim, summed)


def gather_to(x: torch.Tensor, group, dst: int):
    """Every rank's ``x`` of ``group`` (same shape and dtype), in group
    order, on the rank of global rank ``dst`` (a member); ``None`` on the
    others. Outside autograd; gloo gathers CPU tensors."""
    if group is None:
        return [x]
    x = x.contiguous()
    parts = ([torch.empty_like(x) for _ in range(_n(group))]
             if dist.get_rank() == dst else None)
    clock.run(lambda: dist.gather(x, parts, dst=dst, group=group), x,
              "gather")
    return parts


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's rows of ``x`` along the sequence ``dim``, in group
    order; backward: the reduce-scatter of the gradient (each rank's work
    on the gathered rows adds to every row's gradient)."""
    return gather_shards(x, group, dim, summed=True)


class _ScatterPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        chunks = [c.contiguous() for c in x.chunk(_n(group), dim)]
        out = torch.empty_like(chunks[0])
        clock.run(lambda: dist.reduce_scatter(out, chunks, group=group), x,
                  "reduce-scatter")
        return out

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g, ctx.group), dim=ctx.dim), None, None


def scatter_partials(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The sum of the ranks' partials of ``x`` (each the whole sequence),
    this rank's rows of it along ``dim`` (``psum_scatter``); backward: the
    all-gather of the gradient."""
    if group is None:
        return x
    return _ScatterPartials.apply(x, group, dim)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _released(all_reduce_(g.clone(), ctx.group)), None


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _Replicate.apply(x, group)


def _block_slices(x_shape, coords: Sequence[tuple], i: int):
    B, S = x_shape[:2]
    nb = max(c[0] for c in coords) + 1
    ns = max(c[1] for c in coords) + 1
    b, s = coords[i]
    return (slice(b * (B // nb), (b + 1) * (B // nb)),
            slice(s * (S // ns), (s + 1) * (S // ns)))


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, coords, me):
        ctx.group, ctx.coords, ctx.shape = group, coords, x.shape
        rb, rs = _block_slices(x.shape, coords, me)
        return x[rb, rs].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_assemble(_gather(g, ctx.group), ctx.shape, ctx.coords),
                None, None, None)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xb, group, coords, me, shape):
        ctx.coords, ctx.me, ctx.shape = coords, me, shape
        return _assemble(_gather(xb, group), shape, coords)

    @staticmethod
    def backward(ctx, g):
        rb, rs = _block_slices(ctx.shape, ctx.coords, ctx.me)
        return g[rb, rs].contiguous(), None, None, None, None


def _assemble(parts, shape, coords) -> torch.Tensor:
    out = parts[0].new_empty(shape)
    for i, part in enumerate(parts):
        rb, rs = _block_slices(shape, coords, i)
        out[rb, rs] = part
    return out


def take_block(x: torch.Tensor, group, coords: Sequence[tuple], me: int
               ) -> torch.Tensor:
    """Member ``me``'s block of ``x (B, S, ...)`` held whole, where
    ``coords[i] = (b, s)`` places group member ``i``'s block on a grid of
    ``B`` and ``S`` blocks (every member one). Backward: every member's
    block gradient gathered and placed, so the whole tensor's gradient is
    whole on every member. The MoE layer takes the a2a block of a
    replicated input (``moe_layer(rows=None)``), or, from the rank's rows,
    where the expert-parallel axes are not the sequence-parallel ones, and
    the rank's rows back from a replicated body's whole batch."""
    if group is None:
        return x
    return _TakeBlock.apply(x, group, tuple(coords), me)


def gather_blocks(xb: torch.Tensor, group, coords: Sequence[tuple], me: int,
                  shape) -> torch.Tensor:
    """The inverse of :func:`take_block`: every member's block, placed
    into a tensor of ``shape`` held whole; backward: the member's block of
    the (whole) gradient."""
    if group is None:
        return xb
    return _GatherBlocks.apply(xb, group, tuple(coords), me, tuple(shape))
