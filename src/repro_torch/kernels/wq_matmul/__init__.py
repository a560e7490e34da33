"""Weight-quantized matmuls: out-major QTensor storage (``wqt_matmul``,
and ``wqt_matmul_a8`` with int8 activations) and the K-major layout
(``wq_matmul``)."""

from .ops import pack_weight, wq_matmul, wqt_matmul, wqt_matmul_a8
from .ref import (dequant_ref, dequant_t_ref, quantize_acts_ref,
                  quantize_weights_ref, wq_matmul_ref, wqt_matmul_a8_ref,
                  wqt_matmul_ref)

__all__ = ["wqt_matmul", "wqt_matmul_a8", "wq_matmul", "pack_weight",
           "wqt_matmul_ref", "wqt_matmul_a8_ref", "wq_matmul_ref",
           "dequant_t_ref", "dequant_ref", "quantize_acts_ref",
           "quantize_weights_ref"]
