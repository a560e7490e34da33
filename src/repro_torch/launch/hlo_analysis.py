"""Collective statistics and roofline terms of the port's dry-run (the
counterpart of ``repro.launch.hlo_analysis``, whose name it keeps).

The JAX package parses its collectives out of the compiled HLO text; the
port issues every collective itself (``distributed/collectives.py``
counts them by op, bytes and group size), so there is no text to parse:
``collective_stats`` takes ``(op, bytes, group size[, count])`` records
and applies the same ring models to each, in order:

    all-reduce        2 * size * (g-1)/g
    all-gather        out_size * (g-1)/g
    reduce-scatter    in_size * (g-1)/g
    all-to-all        size * (g-1)/g
    collective-permute  size

Ops are named as in HLO (``all_reduce`` and ``all-reduce`` are one op).
``roofline_terms`` uses the H100's constants (``launch/mesh.py``), its
NVLink rate in place of the v5e's ICI links.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, int]          # op kind -> count
    per_op_bytes: Dict[str, float]  # op kind -> wire bytes (per device)
    total_wire_bytes: float
    raw_operand_bytes: float        # spec-literal: sum of operand sizes

    def to_json(self):
        return dataclasses.asdict(self)


def hlo_name(op: str) -> str:
    """``all_reduce`` -> ``all-reduce`` (HLO's spelling)."""
    return op.replace("_", "-")


def collective_stats(records: Iterable) -> CollectiveStats:
    """Counts and wire bytes per op from ``(op, nbytes, group_size)`` or
    ``(op, nbytes, group_size, count)`` records (``nbytes``: the result's
    size, summed over the ``count`` collectives of a record)."""
    counts: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    wire: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    raw = 0.0
    for rec in records:
        op, size, g = rec[0], rec[1], rec[2]
        n = rec[3] if len(rec) > 3 else 1
        kind = hlo_name(op)
        if kind not in counts:
            raise ValueError(f"unknown collective {op!r}")
        frac = (g - 1) / g if g > 1 else 0.0
        counts[kind] += n
        raw += size
        if kind == "all-reduce":
            wire[kind] += 2 * size * frac
        elif kind == "collective-permute":
            wire[kind] += size
        else:
            wire[kind] += size * frac
    return CollectiveStats(
        per_op={k: v for k, v in counts.items() if v},
        per_op_bytes={k: v for k, v in wire.items() if v},
        total_wire_bytes=sum(wire.values()),
        raw_operand_bytes=raw,
    )


def roofline_terms(flops_total: float, hbm_bytes_per_dev: float,
                   wire_bytes_per_dev: float, n_devices: int,
                   n_links: int = 1) -> Dict[str, float]:
    """The three roofline times (seconds) for one step on the mesh, per
    device: FLOPs at the bf16 peak, HBM bytes at the HBM rate, wire bytes
    at ``n_links`` times ``NVLINK_BW`` (the card's whole NVLink rate, one
    direction: ``n_links=1``)."""
    t_compute = flops_total / PEAK_FLOPS_BF16
    t_memory = hbm_bytes_per_dev / HBM_BW
    t_collective = wire_bytes_per_dev / (NVLINK_BW * n_links)
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": dom,
    }
