"""Weight-quantized matmul against out-major QTensor storage."""

from .ops import wqt_matmul
from .ref import dequant_t_ref, wqt_matmul_ref

__all__ = ["wqt_matmul", "wqt_matmul_ref", "dequant_t_ref"]
