"""Refcounted block allocator for the paged KV pool (DESIGN.md §13).

The device side of paged KV is a tree of pool tensors shaped
``(r, n_blocks, block_size, ...)`` plus int32 block tables; all
*ownership* bookkeeping lives here, on the host.  A block is either on
the free list or live with a positive refcount.  One reference is held
per block-table entry pointing at the block and one per prefix-trie
node pinning it; ``unref`` returns the block to the free list when the
count reaches zero.

Block id 0 is reserved as the null/dump block: cleared table rows point
at it, idle decode rows write into it, and it is never allocated, never
refcounted, and never read through a live table.

The port's copy of ``repro.serve.block_pool`` (plain Python, no JAX in either),
kept line for line so that the two packages' bookkeeping stays
comparable in the tests; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

__all__ = ["BlockPool", "PoolExhausted", "NULL_BLOCK"]

NULL_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Typed allocation failure: the pool has fewer free blocks than requested."""

    def __init__(self, requested: int, free: int):
        super().__init__(
            f"paged KV pool exhausted: requested {requested} blocks, {free} free")
        self.requested = requested
        self.free = free


class BlockPool:
    """Host-side free list + per-block refcounts over ``n_blocks`` device blocks.

    Allocation is lowest-id-first so replays are deterministic.  Block 0
    (the null/dump block) is excluded from the allocatable set.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is the reserved null block), got {n_blocks}")
        self.n_blocks = int(n_blocks)
        # Sorted ascending; alloc pops from the front (lowest id first).
        self._free: List[int] = list(range(1, self.n_blocks))
        self._ref: Dict[int, int] = {}

    # -- introspection -------------------------------------------------

    @property
    def capacity(self) -> int:
        """Number of allocatable blocks (excludes the null block)."""
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._ref)

    def free_blocks(self) -> List[int]:
        return list(self._free)

    def live_blocks(self) -> List[int]:
        return sorted(self._ref)

    def refcount(self, bid: int) -> int:
        return self._ref.get(int(bid), 0)

    # -- allocation ----------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` blocks (refcount 1 each) or raise :class:`PoolExhausted`."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(n, len(self._free))
        out, self._free = self._free[:n], self._free[n:]
        for bid in out:
            self._ref[bid] = 1
        return out

    def ref(self, bid: int) -> None:
        """Add a reference to a live block (sharing it into another table/trie pin)."""
        bid = int(bid)
        if bid == NULL_BLOCK:
            raise ValueError("cannot ref the null block")
        if bid not in self._ref:
            raise ValueError(f"ref of non-live block {bid}")
        self._ref[bid] += 1

    def unref(self, bid: int) -> None:
        """Drop a reference; the block returns to the free list at refcount 0."""
        bid = int(bid)
        if bid == NULL_BLOCK:
            raise ValueError("cannot unref the null block")
        c = self._ref.get(bid)
        if c is None:
            raise ValueError(f"unref of non-live block {bid}")
        if c == 1:
            del self._ref[bid]
            # Keep the free list sorted so allocation order stays deterministic.
            bisect.insort(self._free, bid)
        else:
            self._ref[bid] = c - 1

    # -- audit ---------------------------------------------------------

    def audit(self, expected: Optional[Dict[int, int]] = None) -> List[str]:
        """Return violation strings (empty = consistent).

        Structural checks always run: free/live disjoint, every block
        accounted exactly once, no non-positive refcounts.  When
        ``expected`` maps block id -> reference count derived from the
        external holders (block-table entries + trie pins), the per-block
        refcounts must match it exactly and no live block may be
        unaccounted (a leak).
        """
        v: List[str] = []
        free = set(self._free)
        live = set(self._ref)
        if len(free) != len(self._free):
            v.append("free list contains duplicates")
        both = free & live
        if both:
            v.append(f"blocks both free and live: {sorted(both)[:8]}")
        if NULL_BLOCK in free or NULL_BLOCK in live:
            v.append("null block 0 entered the allocator")
        missing = set(range(1, self.n_blocks)) - free - live
        if missing:
            v.append(f"blocks neither free nor live: {sorted(missing)[:8]}")
        stray = (free | live) - set(range(1, self.n_blocks))
        if stray:
            v.append(f"out-of-range block ids: {sorted(stray)[:8]}")
        for bid, c in self._ref.items():
            if c <= 0:
                v.append(f"live block {bid} has non-positive refcount {c}")
        if expected is not None:
            exp = {int(k): int(c) for k, c in expected.items() if int(c) != 0}
            if NULL_BLOCK in exp:
                v.append("external holders reference the null block")
                exp.pop(NULL_BLOCK)
            for bid, c in sorted(exp.items()):
                have = self._ref.get(bid)
                if have is None:
                    v.append(f"block {bid} referenced externally ({c}) but not live")
                elif have != c:
                    v.append(f"block {bid} refcount {have} != external references {c}")
            leaked = sorted(live - set(exp))
            if leaked:
                v.append(f"leaked blocks (live, no external holder): {leaked[:8]}")
        return v
