"""Paged KV-cache: block allocator + block-table bookkeeping (DESIGN.md §14;
a copy of ``repro/runtime/kvcache.py``, which is pure Python).

The static serving path gives every request a ``max_len``-sized slice of
the sharded cache, so short requests pay long requests' padding and a new
batch shape re-``device_put``s the whole cache.  Here the cache is a pool
of fixed-size *blocks* along the sequence dim; each in-flight request owns
just the blocks its length needs, via a per-slot block table mapping
logical position ``p`` → physical slot ``table[p // block_size] *
block_size + p % block_size``.

Everything in this module is host-side pure Python (allocator, layout
math) — the device pool itself lives in the serving engine
(``repro_torch.runtime.serve_loop``), which consumes these tables as plain
int tensors.  Block 0 of every rank's pool is reserved as the *scratch*
block: empty decode slots read and write it so the fixed-width decode
batch never branches on occupancy; nothing real ever maps to it.
"""
from __future__ import annotations

import dataclasses
from collections import deque

SCRATCH_BLOCK = 0


def blocks_for(length: int, block_size: int) -> int:
    """Physical blocks needed to hold ``length`` cache positions."""
    if length <= 0:
        return 0
    return -(-length // block_size)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Shape bookkeeping for one rank's share of the paged pool.

    ``num_blocks`` counts the scratch block; ``max_blocks`` is the block-
    table width (the longest admissible request).  ``seq_capacity`` is
    the gathered sequence extent one decode step sees — callers that
    want bit-exactness with a ``max_len`` static cache should pick
    ``block_size`` dividing ``max_len`` so the extents match.
    """

    block_size: int
    num_blocks: int          # physical blocks per rank, incl. scratch
    max_blocks: int          # block-table width (blocks per request cap)

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError(f"block_size must be > 0, got {self.block_size}")
        if self.num_blocks < 2:
            raise ValueError("need at least one non-scratch block")
        if self.max_blocks < 1:
            raise ValueError("max_blocks must be >= 1")

    @property
    def seq_capacity(self) -> int:
        return self.max_blocks * self.block_size

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1        # minus scratch

    @classmethod
    def for_requests(cls, max_len: int, block_size: int,
                     slots: int) -> "PagedLayout":
        """Layout sized so ``slots`` concurrent max-length requests fit
        (no overcommit)."""
        per = blocks_for(max_len, block_size)
        return cls(block_size=block_size, num_blocks=1 + slots * per,
                   max_blocks=per)


class BlockAllocator:
    """Free-list allocator over one rank's physical blocks.

    All-or-nothing ``alloc`` (a request either gets every block of its
    worst-case length or stays queued — no partial reservations to
    deadlock on), O(1) ``free``.  Block 0 (scratch) is never handed out.
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._free: deque[int] = deque(range(1, layout.num_blocks))
        self._in_use = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self._in_use

    @property
    def utilization(self) -> float:
        return self._in_use / max(self.layout.usable_blocks, 1)

    def can_fit(self, length: int) -> bool:
        return blocks_for(length, self.layout.block_size) <= len(self._free)

    def alloc(self, length: int) -> list[int] | None:
        """Blocks for a ``length``-position request, or None if the pool
        cannot fit it right now (caller keeps the request queued)."""
        n = blocks_for(length, self.layout.block_size)
        if n > self.layout.max_blocks:
            raise ValueError(
                f"request needs {n} blocks > max_blocks="
                f"{self.layout.max_blocks} (length {length})")
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._in_use += n
        return out

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError("scratch block cannot be freed")
            self._free.append(b)
        self._in_use -= len(blocks)
        if self._in_use < 0:
            raise ValueError("double free: more blocks freed than allocated")

    def table_row(self, blocks: list[int]) -> list[int]:
        """A fixed-width block-table row: the request's blocks padded
        with the scratch block (positions past its reservation never
        get written — admission caps length at the reservation)."""
        pad = self.layout.max_blocks - len(blocks)
        return list(blocks) + [SCRATCH_BLOCK] * pad
