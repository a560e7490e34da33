"""Quantization formats (port of ``repro.core.formats``).

* ``IntFormat``: symmetric signed INT-n with a shared absmax scale per
  block; codes lie on ``{-(2^{n-1}-1), ..., 2^{n-1}-1}``.
* ``CodebookFormat``: a non-uniform codebook (FP4 e2m1) scaled so that the
  block absmax maps onto the largest code.

Both expose ``scale(absmax)``, ``neighbors(w, s)`` (the bracketing
representable values ``(lo, hi)``, from which RTN, RR and the LOTION
variance derive), ``rtn``, ``quantize_codes`` and ``dequantize``.
``torch.round`` rounds half to even, like ``jnp.rint``, and the scale's
division is an IEEE one on every device (``numerics.div_scalar``), so casts
match the JAX package bit for bit on the CPU and the card's kernels bit for
bit on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..numerics import div_scalar


@dataclasses.dataclass(frozen=True)
class IntFormat:
    """Symmetric signed INT-n with shared absmax scale per block."""

    bits: int
    name: str = ""

    def __post_init__(self):
        if not self.name:
            object.__setattr__(self, "name", f"int{self.bits}")

    @property
    def qmax(self) -> int:
        """Largest integer code: 2^{n-1} - 1 (no -2^{n-1})."""
        return 2 ** (self.bits - 1) - 1

    def scale(self, absmax: torch.Tensor) -> torch.Tensor:
        """s_B = max|w| / (2^{n-1}-1), guarded against all-zero blocks."""
        return torch.where(absmax > 0, div_scalar(absmax, float(self.qmax)),
                           torch.ones_like(absmax))

    def neighbors(self, w: torch.Tensor, s: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Adjacent representable values (lo, hi) around w; z is clipped
        into [-qmax, qmax] before floor/ceil, as in the JAX format."""
        z = torch.clamp(w / s, -self.qmax, self.qmax)
        return torch.floor(z) * s, torch.ceil(z) * s

    def rtn(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest cast s * round(w / s), half to even."""
        return torch.clamp(torch.round(w / s), -self.qmax, self.qmax) * s

    def quantize_codes(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Integer codes (int8) for storage and packed serving."""
        return torch.clamp(torch.round(w / s), -self.qmax,
                           self.qmax).to(torch.int8)

    def dequantize(self, codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return codes.to(s.dtype) * s


# The positive e2m1 magnitudes; absmax maps onto 6 * s.  The signed
# codebook is the sorted union of +codes and -codes (0 shared).
E2M1_POS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
E2M1_CODES = tuple(np.unique(np.concatenate(
    [-np.array(E2M1_POS), np.array(E2M1_POS)])).tolist())   # 15 values


@dataclasses.dataclass(frozen=True)
class CodebookFormat:
    """Non-uniform codebook with shared absmax scale per block.  ``codes``
    are sorted ascending and contain 0; absmax maps onto ``codes[-1]``."""

    name: str
    codes: tuple

    @property
    def qmax(self) -> float:
        return float(self.codes[-1])

    def code_tensor(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.codes, dtype=like.dtype, device=like.device)

    def scale(self, absmax: torch.Tensor) -> torch.Tensor:
        return torch.where(absmax > 0, div_scalar(absmax, self.qmax),
                           torch.ones_like(absmax))

    def neighbors(self, w: torch.Tensor, s: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bracketing codebook values: ``hi`` is the first code >= z (z =
        w/s clipped to the codebook), ``lo`` is ``hi`` when z is a code and
        the code below it otherwise (``jnp.searchsorted`` semantics)."""
        codes = self.code_tensor(w)
        z = torch.clamp(w / s, self.codes[0], self.codes[-1])
        hi_idx = torch.clamp(torch.searchsorted(codes, z.contiguous(),
                                                side="left"),
                             0, len(self.codes) - 1)
        hi = codes[hi_idx]
        lo_idx = torch.where(hi > z, torch.clamp_min(hi_idx - 1, 0), hi_idx)
        return codes[lo_idx] * s, hi * s

    def rtn(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        lo, hi = self.neighbors(w, s)
        return torch.where(torch.abs(w - lo) <= torch.abs(hi - w), lo, hi)

    def quantize_codes(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Codebook indices (uint8) of the RTN cast."""
        q = self.rtn(w, s) / s
        return torch.argmin(torch.abs(q[..., None] - self.code_tensor(w)),
                            dim=-1).to(torch.uint8)

    def dequantize(self, idx: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return self.code_tensor(s)[idx.long()] * s


INT8 = IntFormat(bits=8)
INT4 = IntFormat(bits=4)
INT2 = IntFormat(bits=2)
FP4_E2M1 = CodebookFormat(name="fp4_e2m1", codes=E2M1_CODES)

FORMATS = {"int8": INT8, "int4": INT4, "int2": INT2, "fp4": FP4_E2M1,
           "fp4_e2m1": FP4_E2M1}


def get_format(name: str):
    try:
        return FORMATS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown quantization format {name!r}; have "
                         f"{sorted(FORMATS)}") from None
