"""Cross-host and cross-replica divergence audit (port of
``repro.distributed.audit``).

* :func:`tree_fingerprint` — one digest of a whole state tree: crc32
  chained over each leaf's key, numpy dtype name and bytes, in the
  checkpoint's key order, so equal trees give equal digests in both
  packages; hosts compare digests through
  :meth:`~repro_torch.distributed.Coordinator.check_fingerprint`.
* :func:`replica_divergence` — device copies covering the same window of
  a leaf must be byte-identical.  In one process a leaf (or, on a mesh,
  this rank's block of it) is one tensor with no replica to disagree
  with, so it reports nothing; comparing the replicas that other ranks
  hold is the mesh chaos tier (ROADMAP Queue 1 item 8(c)).
"""

from __future__ import annotations

import zlib
from typing import List

import torch

from ..checkpoint.io import _crc, _host_array, _paths_and_leaves

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


def tree_fingerprint(tree) -> str:
    """Deterministic digest of a tree's leaves (key + dtype + bytes,
    crc32-chained in key order).  A card leaf comes to the host in runs
    through one pinned buffer; a large run's crc32 is taken on several
    threads (``checkpoint.io._crc``)."""
    crc, buf = 0, None
    for key, leaf in _paths_and_leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_cuda:
            # the numpy dtype name, and bf16 refused, as _host_array does
            dtype = _host_array(key, leaf.reshape(-1)[:0]).dtype
            crc = zlib.crc32(key.encode(), crc)
            crc = zlib.crc32(str(dtype).encode(), crc)
            if leaf.numel():
                if buf is None:
                    buf = torch.empty(FINGERPRINT_RUN, dtype=torch.uint8,
                                      pin_memory=True)
                crc = _card_leaf_crc(crc, leaf, buf)
            continue
        a = _host_array(key, leaf)
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = _crc(a, crc) if a.size else crc
    return f"{crc:08x}"


def replica_divergence(tree, max_report: int = 8) -> List[str]:
    """One violation string per replicated window whose copies differ
    (at most ``max_report``).  On one device every leaf is a single
    copy: always empty."""
    return []
