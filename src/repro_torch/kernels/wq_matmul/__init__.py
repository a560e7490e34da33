"""Weight-quantized matmuls: out-major QTensor storage (``wqt_matmul``,
and with int8 activations ``wqt_matmul_a8`` from codes or
``wqt_matmul_a8_x`` from the activations) and the K-major layout
(``wq_matmul``)."""

from .ops import (pack_weight, wq_matmul, wqt_matmul, wqt_matmul_a8,
                  wqt_matmul_a8_x)
from .ref import (dequant_ref, dequant_t_ref, quantize_acts_ref,
                  quantize_weights_ref, wq_matmul_ref, wqt_matmul_a8_ref,
                  wqt_matmul_a8_x_ref, wqt_matmul_ref)

__all__ = ["wqt_matmul", "wqt_matmul_a8", "wqt_matmul_a8_x", "wq_matmul",
           "pack_weight", "wqt_matmul_ref", "wqt_matmul_a8_ref",
           "wqt_matmul_a8_x_ref", "wq_matmul_ref", "dequant_t_ref",
           "dequant_ref", "quantize_acts_ref", "quantize_weights_ref"]
