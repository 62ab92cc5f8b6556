"""Paged/block KV cache: free-list allocator + watermark admission.

Replaces the implicit "dense ``max_batch × max_seq`` cache, capacity =
lane count" model: cache memory is a pool of fixed-size blocks, each
sequence owns a block table, and admission is gated by the pool's free
headroom — batch capacity is bounded by memory, not a hardcoded constant.

Admission is *committing*: a request reserves its full worst-case block
count up front (prompt + output, clamped to the engine's ``max_seq``), so
``extend`` during decode can never fail mid-request and no preemption
machinery is needed. The ``watermark`` fraction of the pool is held back
from admission as headroom.

On this single-device smoke host the physical JAX cache stays a dense
lane-indexed tensor (a real paged-attention kernel needs a device gather
per block); this module is the *memory accounting* layer that decides
what may run, and its invariants — a block is never double-assigned,
never leaked across request lifecycles — are pinned by property tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from .config import KVCacheConfig

__all__ = ["BlockAllocator", "PagedKVCache", "KVCacheConfig"]


class BlockAllocator:
    """LIFO free-list over ``n_blocks`` fixed-size blocks.

    LIFO keeps recently-freed (cache-warm) blocks hot. Double-frees and
    foreign blocks raise — silent corruption here would surface as
    cross-request KV reuse.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._allocated: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` blocks; raises if the pool cannot satisfy it."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise MemoryError(f"KV pool exhausted: want {n} blocks, "
                              f"{len(self._free)} free of {self.n_blocks}")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"double free / foreign block {b}")
            self._allocated.remove(b)
            self._free.append(b)


@dataclasses.dataclass
class _SeqAlloc:
    blocks: List[int]                # committed block table
    n_tokens: int = 0                # cache rows currently in use


class PagedKVCache:
    """Per-sequence block tables over one :class:`BlockAllocator`.

    Lifecycle: ``can_admit`` → ``allocate(seq_id, total_tokens)`` (commits
    the full reservation) → ``extend(seq_id)`` per decoded token (always
    succeeds inside the reservation) → ``free_seq(seq_id)``.
    """

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self.allocator = BlockAllocator(config.n_blocks)
        self._seqs: Dict[int, _SeqAlloc] = {}
        self.peak_blocks = 0         # high-water mark (utilization stat)

    # -- admission ---------------------------------------------------------

    def _reserve_floor(self) -> int:
        """Blocks the watermark keeps out of admission's reach."""
        return int(self.config.n_blocks * self.config.watermark)

    def can_admit(self, total_tokens: int) -> bool:
        need = self.config.blocks_for(total_tokens)
        return self.allocator.n_free - self._reserve_floor() >= need

    def allocate(self, seq_id: int, total_tokens: int) -> List[int]:
        """Commit the full reservation for a sequence up front."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already allocated")
        blocks = self.allocator.alloc(self.config.blocks_for(total_tokens))
        self._seqs[seq_id] = _SeqAlloc(blocks)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return blocks

    # -- lifecycle ---------------------------------------------------------

    def advance(self, seq_id: int, n_tokens: int) -> None:
        """Mark ``n_tokens`` more cache rows in use (prefill chunk)."""
        s = self._seqs[seq_id]
        s.n_tokens += int(n_tokens)
        cap = len(s.blocks) * self.config.block_size
        if s.n_tokens > cap:
            raise ValueError(f"seq {seq_id} overran its reservation "
                             f"({s.n_tokens} > {cap} rows)")

    def extend(self, seq_id: int) -> None:
        """One decoded token; always inside the committed reservation."""
        self.advance(seq_id, 1)

    def free_seq(self, seq_id: int) -> None:
        s = self._seqs.pop(seq_id)
        self.allocator.free(s.blocks)

    # -- stats -------------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return self.config.n_blocks - self.allocator.n_free

    @property
    def n_seqs(self) -> int:
        return len(self._seqs)

    def utilization(self) -> float:
        return self.used_blocks / self.config.n_blocks
