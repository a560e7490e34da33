"""Quantization core of the port: integer formats, the eligibility policy,
RTN and RR casts, the straight-through estimators of the QAT and RAT
baselines, the training-mode transforms and QTensor quantized storage."""

from .formats import (FORMATS, FP4_E2M1, INT4, INT8, CodebookFormat,
                      IntFormat, bits_of, get_format)
from .lotion import (fisher_from_grads, lotion_penalty,
                     lotion_penalty_and_grad, quadratic_smoothed,
                     smoothed_loss_mc)
from .modes import QuantConfig, cast_params, forward_params, penalty
from .policy import QuantPolicy, path_str
from .qtensor import (QTensor, dequantize_params, from_matmul_weight,
                      has_qtensor, param_nbytes, quantize_params,
                      quantize_qtensor)
from .quantize import (block_scales, cast_rr, cast_rtn, dequantize_store,
                       pack_int4, quantize_store, rr_neighbors, rr_variance,
                       scales_like, unpack_int4)
from .ste import fake_quant_rr, fake_quant_rtn

__all__ = ["FORMATS", "FP4_E2M1", "INT4", "INT8", "CodebookFormat",
           "IntFormat", "bits_of", "get_format",
           "lotion_penalty", "lotion_penalty_and_grad", "smoothed_loss_mc",
           "quadratic_smoothed", "fisher_from_grads",
           "QuantConfig", "cast_params", "forward_params", "penalty",
           "fake_quant_rtn", "fake_quant_rr",
           "QuantPolicy", "path_str", "QTensor", "dequantize_params",
           "from_matmul_weight", "has_qtensor", "param_nbytes",
           "quantize_params", "quantize_qtensor", "block_scales", "cast_rr",
           "cast_rtn", "rr_neighbors", "rr_variance", "scales_like",
           "pack_int4", "unpack_int4", "quantize_store", "dequantize_store"]
