"""The port's collectives over a live :class:`~repro_torch.launch.mesh.Mesh`,
each over named mesh axes, one axis group after another (a product of
axes is the axes in turn: a MAX or a SUM over (pod, data) is the MAX or
SUM over data, then over pod).

This is the one place that talks to ``torch.distributed``.  NCCL carries
CUDA tensors; gloo carries CPU tensors, so on a gloo mesh a CUDA tensor
is staged through host memory here, explicitly: copied to the host, the
collective run there, the result copied back.  ``STAGED`` counts each
staged call by collective; nothing else adds to it.  A staged collective
over an axis of one rank is the identity and is not run (no round trip
through the host); NCCL runs every collective, one-rank axes included.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

STAGED: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def reset_staged() -> None:
    for k in STAGED:
        STAGED[k] = 0


def _staged(mesh, x: torch.Tensor) -> bool:
    return x.is_cuda and mesh.backend == "gloo"


def _pinned(shape, dtype) -> torch.Tensor:
    """A host buffer in pinned memory (the caching host allocator reuses
    it), so the copies to and from the card run at full rate."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def all_reduce(x: torch.Tensor, op: str, mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """``x`` reduced (``op`` in sum, max, min) over the ranks of ``axes``,
    in place; returns ``x``."""
    import torch.distributed as dist
    rop = getattr(dist.ReduceOp, _OPS[op])
    for axis in axes:
        staged = _staged(mesh, x)
        if staged and mesh.shape[axis] == 1:
            continue
        group = mesh.group(axis)
        if staged:
            STAGED["all_reduce"] += 1
            h = _pinned(x.shape, x.dtype)
            h.copy_(x)
            dist.all_reduce(h, rop, group=group)
            x.copy_(h)
        else:
            dist.all_reduce(x, rop, group=group)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, concatenated along ``dim`` in
    rank order (the order of the axis's coordinate)."""
    import torch.distributed as dist
    n = mesh.shape[axis]
    staged = _staged(mesh, x)
    if staged and n == 1:
        return x
    group = mesh.group(axis)
    if not staged:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)
    STAGED["all_gather"] += 1
    src = _pinned(x.shape, x.dtype)
    src.copy_(x)
    parts = [_pinned(x.shape, x.dtype) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    out = _pinned(tuple(shape), x.dtype)
    torch.cat(parts, dim=dim, out=out)
    return out.to(x.device)


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank of the
    world."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
