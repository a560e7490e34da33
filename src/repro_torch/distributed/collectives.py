"""The port's collectives over a live :class:`~repro_torch.launch.mesh.Mesh`,
each over named mesh axes, one axis group after another (a product of
axes is the axes in turn: a MAX or a SUM over (pod, data) is the MAX or
SUM over data, then over pod).

This is the one place that talks to ``torch.distributed``.  NCCL carries
CUDA tensors; gloo carries CPU tensors, so on a gloo mesh a CUDA tensor
is staged through host memory here, explicitly: copied to the host, the
collective run there, the result copied back.  ``STAGED`` counts each
staged call by collective; nothing else adds to it.  A collective over an
axis of one rank is the identity and is not issued, on any backend.

``ISSUED`` counts every collective issued, by op and group size, with its
bytes (the result's: the reduced tensor of an all-reduce, the gathered one
of an all-gather, as JAX's HLO analysis reads a collective's size);
``issued()`` sums it by op.  The live runs report it, and the dry-run's
trace of the same step (``launch/dryrun.py``, through ``CommDebugMode``)
must issue the same collectives.  The object collectives
(``broadcast_object``, ``gather_objects``) carry host decisions and
digests, not tensors, and are not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

STAGED: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
# (op, group size) -> [count, bytes]
ISSUED: Dict[Tuple[str, int], list] = {}

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def reset_staged() -> None:
    for k in STAGED:
        STAGED[k] = 0


def reset_issued() -> None:
    ISSUED.clear()


def _issue(op: str, group_size: int, nbytes: int) -> None:
    rec = ISSUED.setdefault((op, int(group_size)), [0, 0])
    rec[0] += 1
    rec[1] += int(nbytes)


def issued() -> Dict[str, int]:
    """Collectives issued since the last ``reset_issued``, by op."""
    out: Dict[str, int] = {}
    for (op, _), (n, _) in ISSUED.items():
        out[op] = out.get(op, 0) + n
    return out


def issued_records() -> list:
    """``(op, bytes, group size)`` of every (op, group size) class, its
    bytes summed: what ``hlo_analysis.collective_stats`` takes."""
    return [(op, nbytes, g, n) for (op, g), (n, nbytes) in
            sorted(ISSUED.items())]


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
        if mesh.shape[axis] == 1:
            continue
        staged = _staged(mesh, x)
        group = mesh.group(axis)
        _issue("all_reduce", mesh.shape[axis], x.numel() * x.element_size())
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
    if n == 1:
        return x
    staged = _staged(mesh, x)
    group = mesh.group(axis)
    _issue("all_gather", n, n * x.numel() * x.element_size())
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


def world_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (a small host tensor), stacked in rank order:
    ``(world, *x.shape)`` on the host.  On NCCL it goes through the
    rank's card."""
    import torch.distributed as dist
    n = dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    src = x.to(dev).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    _issue("all_gather", n, n * src.numel() * src.element_size())
    dist.all_gather(parts, src)
    return torch.stack(parts).cpu()


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank of the
    world."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's ``obj`` (any picklable value), in rank order, on every
    rank of the world; ``[obj]`` in a world of one."""
    import torch.distributed as dist
    if dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
