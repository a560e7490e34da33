"""Shared-prefix KV reuse: a chunk-granular radix trie over token-ID
prefixes (DESIGN.md §8).

Chat/system-prompt traffic re-prefills the same leading tokens for every
request.  Because chunked prefill is deterministic and chunk boundaries
are absolute (aligned from position 0 at a fixed width), the KV block a
request computes for prompt chunk ``[i*c, (i+1)*c)`` is a pure function
of the prompt prefix ``prompt[:(i+1)*c]`` — so blocks can be keyed by
the token IDs alone and spliced into any later request that shares the
prefix, skipping that prefix's prefill FLOPs entirely.  Exact-match
semantics: only whole-chunk token-ID matches count, and the payload is
the *dense* (pre-kv-quant) block bytes the producer computed, so a
consumer resuming chunked prefill from a hit computes exactly what it
would have computed alone — greedy outputs stay token-identical.

Mechanics:

* **Trie, one chunk per edge** — node key = the chunk's token tuple;
  matching walks whole chunks (chunk-granular, the resume position is
  always a chunk boundary).  A lookup never consumes the FULL prompt:
  the match is capped so at least one prompt token remains to prefill
  (the last token's logits seed sampling and are not cached).
* **Refcounting** — ``lookup`` pins the matched path until the consumer
  finishes its prefill (``release``); pinned nodes are never evicted, so
  a hit stays valid even if the cache churns mid-flight.
* **LRU eviction** — capacity is counted in blocks; over capacity, the
  least-recently-used unpinned LEAF is evicted first (children hold a
  structural pin on their ancestors — an interior block must outlive any
  deeper block that extends it).

Payloads are opaque to this module (the scheduler stores per-layer KV
chunk copies: on the host in ring mode, on the device in paged mode);
memory accounting is block-count-based.

The port's copy of ``repro.serve.prefix_cache`` (plain Python, no JAX in either),
kept line for line so that the two packages' bookkeeping stays
comparable in the tests; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class _Node:
    """One chunk edge of the radix trie."""

    key: Tuple[int, ...]
    payload: Any
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    refcount: int = 0
    last_used: int = 0


class PrefixCache:
    """Chunk-granular radix trie of prefill KV blocks (refcounted, LRU)."""

    def __init__(self, block: int, capacity_blocks: int = 256,
                 on_evict=None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if capacity_blocks < 1:
            raise ValueError(
                f"capacity_blocks must be >= 1, got {capacity_blocks}")
        self.block = block
        self.capacity_blocks = capacity_blocks
        # Called with the evicted node's payload at EVERY eviction site
        # (flush / over-capacity / explicit reclaim) — the paged scheduler
        # uses it to unpin the trie's block-pool reference (DESIGN.md §13).
        self.on_evict = on_evict
        self._root = _Node(key=(), payload=None, parent=None)
        self._clock = 0
        self.n_blocks = 0
        # telemetry (the bench's structural prefill-FLOPs-saved columns)
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    # lookup / release
    # ------------------------------------------------------------------

    def lookup(self, prompt: Sequence[int]) -> Tuple[int, List[_Node]]:
        """Longest whole-chunk prefix match, capped at ``len(prompt)-1``
        tokens.  Pins every matched node (caller MUST ``release`` when
        its prefill completes).  Returns (matched_tokens, nodes)."""
        self._clock += 1
        max_chunks = max(len(prompt) - 1, 0) // self.block
        node, path = self._root, []
        for i in range(max_chunks):
            key = tuple(prompt[i * self.block:(i + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                break
            child.refcount += 1
            child.last_used = self._clock
            path.append(child)
            node = child
        if path:
            self.hits += 1
            self.tokens_saved += len(path) * self.block
        else:
            self.misses += 1
        return len(path) * self.block, path

    def release(self, nodes: List[_Node]) -> None:
        """Unpin a ``lookup`` path (the consumer's prefill is done)."""
        for n in nodes:
            if n.refcount <= 0:
                raise RuntimeError("release without a matching lookup pin")
            n.refcount -= 1

    # ------------------------------------------------------------------
    # insert / eviction
    # ------------------------------------------------------------------

    def insert(self, prompt: Sequence[int], blocks: Sequence[Any]) -> int:
        """Add the first ``len(blocks)`` whole chunks of ``prompt`` (block
        ``i`` covers tokens ``[i*block, (i+1)*block)``).  Chunks already
        present keep their payload (exactness makes re-computed blocks
        interchangeable).  Returns the number of NEW blocks stored."""
        if len(blocks) * self.block > len(prompt):
            raise ValueError(
                f"{len(blocks)} blocks of {self.block} tokens exceed the "
                f"{len(prompt)}-token prompt")
        self._clock += 1
        node, added = self._root, 0
        for i, payload in enumerate(blocks):
            key = tuple(prompt[i * self.block:(i + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, payload=payload, parent=node)
                node.children[key] = child
                self.n_blocks += 1
                added += 1
            child.last_used = self._clock
            node = child
        self._evict_over_capacity()
        return added

    def flush(self) -> int:
        """Evict EVERY unpinned block (the chaos harness's eviction
        storm): repeatedly strip unpinned leaves until only pinned paths
        (and their ancestors) remain.  Returns blocks evicted."""
        before = self.n_blocks
        changed = True
        while changed:
            changed = False
            for n in list(self.nodes()):
                if not n.children and n.refcount == 0:
                    self._evict_node(n)
                    changed = True
        return before - self.n_blocks

    def path(self, prompt: Sequence[int], k_chunks: int) -> List[_Node]:
        """Walk the trie along ``prompt``'s first ``k_chunks`` chunk keys
        and return the nodes found (a prefix of the requested path; stops
        at the first absent chunk).  No pinning, no LRU touch — this is
        the post-``insert`` handle the paged scheduler uses to attach
        block ids to the nodes it just published."""
        node, out = self._root, []
        for i in range(k_chunks):
            key = tuple(prompt[i * self.block:(i + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def evict_unpinned(self, n: int) -> int:
        """Evict up to ``n`` least-recently-used unpinned leaves (the
        paged pool's reclaim path under block pressure).  Returns the
        number actually evicted (0 = nothing evictable)."""
        evicted = 0
        while evicted < n:
            victim = self._lru_unpinned_leaf()
            if victim is None:
                break
            self._evict_node(victim)
            evicted += 1
        return evicted

    # ------------------------------------------------------------------
    # invariant audit (serve/faults.py leans on these)
    # ------------------------------------------------------------------

    def nodes(self):
        """Every live node (pre-order)."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def total_refcount(self) -> int:
        return sum(n.refcount for n in self.nodes())

    def refcount_imbalance(self, pinned_paths) -> List[str]:
        """Audit refcount balance against the caller's outstanding pins
        (``pinned_paths``: one ``lookup``-returned node list per in-flight
        consumer).  Every node's refcount must equal the number of live
        paths holding it — a mismatch is a pin leak (a consumer died
        without ``release``) or a double release.  Also re-counts
        ``n_blocks`` against the live trie."""
        expected: Dict[int, int] = {}
        for path in pinned_paths:
            for n in path:
                expected[id(n)] = expected.get(id(n), 0) + 1
        problems, walked = [], 0
        for n in self.nodes():
            walked += 1
            want = expected.pop(id(n), 0)
            if n.refcount != want:
                problems.append(
                    f"node {n.key}: refcount {n.refcount} != {want} "
                    f"outstanding pins")
        for _ in expected:
            problems.append("pinned node no longer reachable in the trie "
                            "(evicted while pinned)")
        if walked != self.n_blocks:
            problems.append(
                f"n_blocks accounting drift: counter {self.n_blocks} vs "
                f"{walked} live nodes")
        return problems

    def _lru_unpinned_leaf(self) -> Optional[_Node]:
        victim = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if not n.children and n.refcount == 0 and (
                    victim is None or n.last_used < victim.last_used):
                victim = n
            stack.extend(n.children.values())
        return victim

    def _evict_node(self, victim: _Node) -> None:
        del victim.parent.children[victim.key]
        self.n_blocks -= 1
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(victim.payload)

    def _evict_over_capacity(self) -> None:
        while self.n_blocks > self.capacity_blocks:
            victim = self._lru_unpinned_leaf()
            if victim is None:
                return                 # everything live is pinned
            self._evict_node(victim)

    def stats(self) -> dict:
        return {"blocks": self.n_blocks, "hits": self.hits,
                "misses": self.misses, "tokens_saved": self.tokens_saved,
                "evictions": self.evictions}
