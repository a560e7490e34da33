"""Cross-host and cross-replica divergence audit (port of
``repro.distributed.audit``).

* :func:`tree_fingerprint` — one digest of a whole state tree: crc32
  chained over each leaf's key, numpy dtype name and bytes, in the
  checkpoint's key order, so equal trees give equal digests in both
  packages; hosts compare digests through
  :meth:`~repro_torch.distributed.Coordinator.check_fingerprint`.
* :func:`replica_divergence` — device copies covering the same window of
  a leaf must be byte-identical.  The port runs on one device, where a
  leaf is one tensor on one device and has no replica to disagree with,
  so it reports nothing; it stays as the seam a sharded port (ROADMAP
  Queue 1 item 8) fills.
"""

from __future__ import annotations

import concurrent.futures
import zlib
from typing import List

from ..checkpoint.io import _host_array, _paths_and_leaves


def _chain(crc: int, key: str, a) -> int:
    crc = zlib.crc32(key.encode(), crc)
    crc = zlib.crc32(str(a.dtype).encode(), crc)
    return zlib.crc32(a, crc) if a.size else crc


def tree_fingerprint(tree) -> str:
    """Deterministic digest of a tree's leaves (key + dtype + bytes,
    crc32-chained in key order).  A leaf's crc32 runs in a second thread
    while the next leaf comes to the host."""
    crc = 0
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = None
        for key, leaf in _paths_and_leaves(tree):
            a = _host_array(key, leaf)
            crc = fut.result() if fut is not None else crc
            fut = pool.submit(_chain, crc, key, a)
        crc = fut.result() if fut is not None else crc
    return f"{crc:08x}"


def replica_divergence(tree, max_report: int = 8) -> List[str]:
    """One violation string per replicated window whose copies differ
    (at most ``max_report``).  On one device every leaf is a single
    copy: always empty."""
    return []
