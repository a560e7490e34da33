"""Float arithmetic that rounds as the JAX package's (and the CUDA
kernels') does, where PyTorch's default differs.

* PyTorch divides a CUDA tensor by a Python number as a multiplication by
  its reciprocal, which can differ in the last bit from IEEE division; a
  0-d tensor divisor on the same device keeps the division exact
  (``div_scalar``, ``scalar``).  ``number / tensor`` is likewise a
  reciprocal times the number on every device.
* PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded (about
  0.6% of inputs differ in the last bit); XLA's and CUDA's are.
  ``sqrt_rn`` takes the CPU's through float64, which rounds to the same
  float32 as an IEEE float32 square root.
"""

from __future__ import annotations

import torch


def scalar(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (a number or 0-d tensor) as a 0-d tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(())


def div_scalar(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as one IEEE division on every device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)
