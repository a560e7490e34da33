"""Cross-host and cross-replica divergence audit (port of
``repro.distributed.audit``).

* :func:`tree_fingerprint` — one digest of a whole state tree: crc32
  chained over each leaf's key, numpy dtype name and bytes, in the
  checkpoint's key order, so equal trees give equal digests in both
  packages; hosts compare digests through
  :meth:`~repro_torch.distributed.Coordinator.check_fingerprint`.
* :func:`replica_divergence` — copies covering the same window of a
  leaf must be byte-identical.  In one process a leaf is one tensor with
  no replica to disagree with, so it reports nothing.

On a mesh (``shardings``: the tree's NamedShardings, its leaves this
rank's blocks) both read :class:`BlockDigests`: each rank takes the
crc32 of every contiguous run its block covers in the full leaf's
bytes, and one ``collectives.gather_objects`` gives every rank every
rank's runs.  The runs, chained in the full leaf's order with the crc32
combination (``checkpoint/io.py``), give the digest of the full leaves,
the one-device ``tree_fingerprint`` of the gathered state, with no
gather of the state; the ranks that hold the same window (the replicas
of a leaf over the axes that do not cut it) are compared run by run.
"""

from __future__ import annotations

import math
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint.io import (_advance, _crc, _host_array, _paths_and_leaves,
                             crc32_combine)

# bytes of a card leaf brought to the host at a time, into one pinned
# buffer, for its crc32
FINGERPRINT_RUN = 1 << 28


def _card_leaf_crc(crc: int, x: torch.Tensor, buf: torch.Tensor) -> int:
    """``crc`` chained over the bytes of the card tensor ``x``, a run of
    ``FINGERPRINT_RUN`` bytes at a time through the pinned ``buf``."""
    flat = x.detach().reshape(-1).contiguous().view(torch.uint8)
    for i in range(0, flat.numel(), FINGERPRINT_RUN):
        run = flat[i:i + FINGERPRINT_RUN]
        buf[:run.numel()].copy_(run)
        crc = _crc(buf[:run.numel()].numpy(), crc)
    return crc


def _leaf_header(crc: int, key: str, dtype) -> int:
    crc = zlib.crc32(key.encode(), crc)
    return zlib.crc32(str(dtype).encode(), crc)


def tree_fingerprint(tree, shardings=None) -> str:
    """Deterministic digest of a tree's leaves (key + dtype + bytes,
    crc32-chained in key order).  A card leaf comes to the host in runs
    through one pinned buffer; a large run's crc32 is taken on several
    threads (``checkpoint.io._crc``).  With ``shardings`` the leaves are
    blocks and the digest is this rank's view of the full leaves
    (:class:`BlockDigests`): on sound replicas, every rank's digest and
    the one-device digest of the gathered tree."""
    if shardings is not None:
        return BlockDigests(tree, shardings).fingerprint()
    crc, buf = 0, None
    for key, leaf in _paths_and_leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_cuda:
            # the numpy dtype name, and bf16 refused, as _host_array does
            crc = _leaf_header(crc, key,
                               _host_array(key, leaf.reshape(-1)[:0]).dtype)
            if leaf.numel():
                if buf is None:
                    buf = torch.empty(FINGERPRINT_RUN, dtype=torch.uint8,
                                      pin_memory=True)
                crc = _card_leaf_crc(crc, leaf, buf)
            continue
        a = _host_array(key, leaf)
        crc = _leaf_header(crc, key, a.dtype)
        crc = _crc(a, crc) if a.size else crc
    return f"{crc:08x}"


def replica_divergence(tree, max_report: int = 8, shardings=None
                       ) -> List[str]:
    """One violation string per replicated window whose copies differ
    (at most ``max_report``).  On one device every leaf is a single
    copy: always empty.  With ``shardings`` the ranks that hold the same
    window of a leaf are compared (:class:`BlockDigests`)."""
    if shardings is None:
        return []
    return BlockDigests(tree, shardings).divergence(max_report)


def _shift_table(nbytes: int) -> np.ndarray:
    """``_advance(., nbytes)`` (linear over GF(2)) as the images of the
    32 unit vectors."""
    return np.array([_advance(1 << j, nbytes) for j in range(32)],
                    np.uint32)


def combine_runs(crcs: np.ndarray, nbytes: int) -> int:
    """crc32 of the bytes of ``len(crcs)`` runs of ``nbytes`` each, in
    order, from each run's own crc32: neighbours combined pairwise, a
    level at a time over the whole array (a run left over at the right
    end of a level is joined last)."""
    v = np.asarray(crcs, np.uint32)
    tail = []
    while len(v) > 1:
        if len(v) % 2:
            tail.append((int(v[-1]), nbytes))
            v = v[:-1]
        table, left = _shift_table(nbytes), v[0::2]
        shifted = np.zeros_like(left)
        for j in range(32):
            shifted ^= np.where((left >> np.uint32(j)) & np.uint32(1),
                                table[j], np.uint32(0))
        v = shifted ^ v[1::2]
        nbytes *= 2
    crc = int(v[0]) if len(v) else 0
    for c, n in reversed(tail):
        crc = crc32_combine(crc, c, n)
    return crc


def _block_runs(x: torch.Tensor, sh):
    """(window, element offsets of the runs in the full flattened leaf,
    run length in elements) of the block ``x`` of a leaf placed by
    ``sh``: the runs are the block's flat order cut where the full
    leaf's order leaves it."""
    from .sharding import global_shape, shard_slices
    local = tuple(x.shape)
    full = global_shape(sh, local)
    cut = [d for d in range(len(full)) if local[d] != full[d]]
    if not cut:
        return tuple((0, n) for n in full), np.zeros(1, np.int64), \
            math.prod(full)
    sl = shard_slices(sh, full)
    window = tuple((s.start or 0, s.stop if s.stop is not None else n)
                   for s, n in zip(sl, full))
    k = cut[-1]
    inner = math.prod(full[k + 1:])
    offs = np.full((), window[k][0] * inner, np.int64)
    for d in range(k):
        stride = math.prod(full[d + 1:])
        idx = (window[d][0] + np.arange(local[d], dtype=np.int64)) * stride
        offs = offs[..., None] + idx
    return window, offs.reshape(-1), local[k] * inner


class BlockDigests:
    """The crc32 of each contiguous run of every rank's block of each leaf
    of ``tree`` (its leaves this rank's blocks, placed by ``shardings``),
    gathered from every rank with one ``collectives.gather_objects``.

    ``fingerprint(rank)`` is that rank's digest of the full leaves: for
    each window its own runs where it holds the window, else the lowest
    rank's; ``rank_digests()`` every rank's; ``divergence()`` one
    violation per window whose copies differ."""

    def __init__(self, tree, shardings):
        from . import collectives
        from .sharding import mesh_of
        self.rank = mesh_of(shardings).rank
        sh_of = dict(_paths_and_leaves(shardings))
        mine = []
        for key, leaf in _paths_and_leaves(tree):
            a = _host_array(key, leaf)
            window, offs, run = _block_runs(leaf, sh_of[key])
            nbytes = run * a.dtype.itemsize
            b = a.reshape(-1).view(np.uint8)
            crcs = np.array([_crc(b[i * nbytes:(i + 1) * nbytes])
                             for i in range(len(offs))], np.uint32)
            mine.append((key, str(a.dtype), window, offs, nbytes, crcs))
        self.leaves = collectives.gather_objects(mine)

    def _chosen(self, i: int, rank: int) -> list:
        """The runs of leaf ``i`` as ``rank`` sees them: per window,
        (offsets, run bytes, crcs) of its own copy, else the lowest
        rank's."""
        chosen = {}
        order = [rank] + [r for r in range(len(self.leaves)) if r != rank]
        for r in order:
            _, _, window, offs, nbytes, crcs = self.leaves[r][i]
            chosen.setdefault(window, (offs, nbytes, crcs))
        return list(chosen.values())

    def fingerprint(self, rank: Optional[int] = None) -> str:
        rank = self.rank if rank is None else rank
        crc = 0
        for i, (key, dtype, *_) in enumerate(self.leaves[rank]):
            crc = _leaf_header(crc, key, dtype)
            chosen = self._chosen(i, rank)
            offs = np.concatenate([offs for offs, _, _ in chosen])
            crcs = np.concatenate([crcs for _, _, crcs in chosen])
            sizes = {nbytes for _, nbytes, _ in chosen}
            if len(sizes) != 1:
                raise ValueError(f"{key!r}: the ranks' blocks differ in "
                                 f"shape")
            nbytes = sizes.pop()
            crc = crc32_combine(crc, combine_runs(crcs[np.argsort(offs)],
                                                  nbytes),
                                nbytes * len(crcs))
        return f"{crc:08x}"

    def rank_digests(self) -> List[str]:
        return [self.fingerprint(r) for r in range(len(self.leaves))]

    def divergence(self, max_report: int = 8) -> List[str]:
        bad: List[str] = []
        for i, (key, *_) in enumerate(self.leaves[0]):
            seen = {}
            for r, leaf in enumerate(self.leaves):
                window, crcs = leaf[i][2], leaf[i][5]
                first = seen.setdefault(window, (r, crcs))
                if not np.array_equal(first[1], crcs):
                    bad.append(f"replica divergence in {key!r} window "
                               f"{window}: rank {r} disagrees with rank "
                               f"{first[0]}")
                    if len(bad) >= max_report:
                        return bad
        return bad
