"""PyTorch/CUDA port of the LOTION package ``repro``, for one NVIDIA H100.

The JAX package ``repro`` is the reference and this package never imports
it (nor JAX).  Module paths and function names mirror ``repro``'s, so each
counterpart is easy to find; inside, the code is PyTorch: parameters are
plain nested dicts of tensors keyed like the JAX tree, every entry point
takes an explicit ``device`` (default ``"cuda"``), randomness comes from
``torch.Generator``, and the TPU's Pallas kernels are CUDA C++ kernels
under ``kernels/``.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    asks for another.  Raises when CUDA is asked for (explicitly or by
    default) and absent, rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch paths")
    return dev


