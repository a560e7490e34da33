"""Device meshes of the port (``repro.launch.mesh``).

``make_mesh`` is a FUNCTION: importing this module touches no device and
no process group.  A mesh has named axes, ``(data, model)`` or ``(pod,
data, model)``; ``pod`` is an outer data-parallel axis.  One process
drives one rank: under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) the world size must equal the mesh's size and each rank
takes ``cuda:LOCAL_RANK``; a mesh of one rank needs no ``torchrun`` and
makes its world of one from a local store.  The process group is NCCL
for CUDA tensors and gloo for CPU tensors; a caller that initialised the
default group itself (gloo for two ranks sharing one card) keeps it.

:class:`Mesh` holds the axis names and sizes (all the sharding rules
read) and, once live, the ``torch.distributed`` ``DeviceMesh`` whose
per-axis groups the collectives use.  ``Mesh(shape, axes)`` without a
device mesh is an abstract mesh for the rules alone (tests, the specs at
full size).

``make_production_mesh`` gives the dry-run's meshes, JAX's shapes:
(16, 16) ``(data, model)`` and (2, 16, 16) ``(pod, data, model)``;
abstract, or with ``live=True`` live in this one process through torch's
fake process group at the mesh's world size, as rank 0
(``make_fake_mesh``): its collectives move nothing, and
``launch/dryrun.py`` traces one rank's step on fake tensors there.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence

import torch

# NVIDIA H100 SXM5 80GB HBM3 (NVIDIA data sheet; the card the port is
# measured on reports "NVIDIA H100 80GB HBM3" and a 700 W power limit):
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s per direction (NVLink 4, 18 links)
HBM_BYTES = 80e9                # device memory

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0


class Mesh:
    """Named mesh axes with their sizes (``shape[axis]``), and for a live
    mesh the ``DeviceMesh``, the device its tensors live on and the
    process group's backend."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None, device: Optional[torch.device] = None,
                 backend: Optional[str] = None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def live(self) -> bool:
        return self.device_mesh is not None

    def _need_live(self):
        if self.device_mesh is None:
            raise RuntimeError("an abstract mesh has no ranks: build it with "
                               "make_mesh")

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        self._need_live()
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._need_live()
        return self.device_mesh.get_group(axis)

    @property
    def rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank() if self.live else 0

    def __repr__(self):
        return f"Mesh({self.shape})"


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda", *,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A live mesh of ``shape`` over ``torch.distributed``'s
    ``init_device_mesh``; initialises the default process group if no one
    has (from ``torchrun``'s environment, or a world of one from a local
    store).  ``device`` names the device type; a CUDA rank takes
    ``cuda:LOCAL_RANK``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .. import resolve_device

    dev = resolve_device(device)
    size = math.prod(int(s) for s in shape)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend_for(dev), timeout=timeout)
        elif size == 1:
            dist.init_process_group(_backend_for(dev), store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
        else:
            raise ValueError(
                f"a mesh of {size} ranks needs {size} processes: run it "
                f"under torchrun --nproc-per-node {size}")
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {tuple(shape)} has {size} ranks but the "
                         f"world has {dist.get_world_size()}")
    backend = str(dist.get_backend())
    # gloo groups carry CPU tensors: a gloo mesh is a CPU device mesh
    # whatever device the tensors live on (collectives.py stages them)
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(int(s) for s in shape),
                          mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, device_mesh=dm, device=dev, backend=backend)


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str],
                   device=None) -> Mesh:
    """A live mesh of ``shape`` in this process alone: torch's fake
    process group (``FakeStore``, backend ``"fake"``) at the mesh's world
    size, this process as rank 0.  ``device`` is where its tensors live
    (the dry-run's fake tensors; default the card where there is one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: a fake mesh "
                           "needs a process of its own")
    size = math.prod(int(s) for s in shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    dm = init_device_mesh("cpu", tuple(int(s) for s in shape),
                          mesh_dim_names=tuple(axes))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return Mesh(shape, axes, device_mesh=dm, device=torch.device(device),
                backend="fake")


def make_production_mesh(*, multi_pod: bool = False, live: bool = False,
                         device=None) -> Mesh:
    """JAX's production meshes: (16, 16) ``(data, model)``, or with
    ``multi_pod`` (2, 16, 16) ``(pod, data, model)``; abstract, or with
    ``live`` a fake mesh of this process (``make_fake_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if live:
        return make_fake_mesh(shape, axes, device)
    return Mesh(shape, axes)


def close_mesh() -> None:
    """Destroy the default process group (and with it every mesh)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod is outer DP)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def parse_mesh(text: str):
    """``"DxM"`` or ``"PxDxM"`` -> (shape, axes)."""
    shape = tuple(int(x) for x in text.split("x"))
    if len(shape) == 2:
        return shape, ("data", "model")
    if len(shape) == 3:
        return shape, ("pod", "data", "model")
    raise ValueError(f"--mesh takes DxM or PxDxM, got {text!r}")
