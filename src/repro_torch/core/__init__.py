"""Quantization core of the port: integer formats, the eligibility policy,
RTN casts and QTensor quantized storage."""

from .formats import FORMATS, INT4, INT8, IntFormat, get_format
from .policy import QuantPolicy, path_str
from .qtensor import (QTensor, dequantize_params, from_matmul_weight,
                      has_qtensor, param_nbytes, quantize_params,
                      quantize_qtensor)

__all__ = ["FORMATS", "INT4", "INT8", "IntFormat", "get_format",
           "QuantPolicy", "path_str", "QTensor", "dequantize_params",
           "from_matmul_weight", "has_qtensor", "param_nbytes",
           "quantize_params", "quantize_qtensor"]
