"""Integer quantization format (port of ``repro.core.formats.IntFormat``).

Symmetric signed INT-n with a shared absmax scale per block: codes lie on
``{-(2^{n-1}-1), ..., 2^{n-1}-1}``.  ``torch.round`` rounds half to even,
like ``jnp.rint``, so codes and casts match the JAX package bit for bit.
Codebook formats (FP4) are not in this slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch


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
        return torch.where(absmax > 0, absmax / self.qmax,
                           torch.ones_like(absmax))

    def rtn(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest cast s * round(w / s), half to even."""
        return torch.clamp(torch.round(w / s), -self.qmax, self.qmax) * s

    def quantize_codes(self, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Integer codes (int8) for storage and packed serving."""
        return torch.clamp(torch.round(w / s), -self.qmax,
                           self.qmax).to(torch.int8)

    def dequantize(self, codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return codes.to(s.dtype) * s


INT8 = IntFormat(bits=8)
INT4 = IntFormat(bits=4)
INT2 = IntFormat(bits=2)

FORMATS = {"int8": INT8, "int4": INT4, "int2": INT2}
_NOT_PORTED = ("fp4", "fp4_e2m1")


def get_format(name: str) -> IntFormat:
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"format {name!r} (CodebookFormat) is not ported yet: "
            f"ROADMAP Queue 1 item 2 (core/formats.py CodebookFormat)")
    try:
        return FORMATS[key]
    except KeyError:
        raise ValueError(f"unknown quantization format {name!r}; have "
                         f"{sorted(FORMATS)}") from None
