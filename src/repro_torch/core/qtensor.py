"""QTensor: quantized-storage weights for the serving path (port of
``repro.core.qtensor``).

Layout contract, as in the JAX package: a QTensor stores a matrix
out-major, ``(..., N, K)`` with K the contraction axis of the matmul it
serves (the transpose of the ``x @ w`` operand), quant blocks along K.

* ``codes``: int8 ``(..., N, K)`` or packed int4 uint8 ``(..., N, K//2)``,
  two K-values per byte, even K in the low nibble;
* ``scales``: fp32 ``(..., 1, 1)`` per matrix or ``(..., N, K//bs)``;
* ``fmt_name``, ``bits``, ``block_k`` (-1 = per matrix).

A stacked ``(r, N, K)`` QTensor (one matrix per layer) gives its per-layer
2-D view with ``qt.layer(i)``.  ``matmul`` serves 2-D storage through the
``wqt_matmul`` CUDA kernel for CUDA tensors and through its plain version
for CPU tensors.  Under ``qtensor_act_fmt("int8")`` (W4A8 / W8A8 serving)
it serves through ``wqt_matmul_a8_x`` instead, which row-quantizes its
activations to int8 codes and fp32 row scales, contracts and casts back in
one ``wqt_matmul_a8`` launch.  3-D storage (an unstacked MoE expert tree,
(E, N, K)) makes one such call per expert.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..kernels.wq_matmul import dequant_t_ref, wqt_matmul, wqt_matmul_a8_x
from ..kernels.wq_matmul.ref import _pack_last
from .formats import IntFormat, get_format
from .policy import QuantPolicy, path_str, tree_leaves, tree_map_with_path


# --------------------------------------------------------------------------
# Activation format (W4A8 serving): under "int8" every QTensor matmul
# row-quantizes its activations to int8 codes + fp32 row scales first, so
# the contraction runs int8 x int[4|8].  Read at call time; a context
# variable, so threads and tasks each see their own setting.
# --------------------------------------------------------------------------

_ACT_FMT: contextvars.ContextVar = contextvars.ContextVar(
    "qtensor_act_fmt", default=None)


def _check_act_fmt(fmt) -> None:
    if fmt not in (None, "int8"):
        raise ValueError(
            f"act_fmt supports None (dense) or 'int8', got {fmt!r}")


def set_qtensor_act_fmt(fmt: Optional[str]) -> None:
    """Set ("int8") or clear (None) activation quantization for QTensor
    matmuls in the current context."""
    _check_act_fmt(fmt)
    _ACT_FMT.set(fmt)


@contextlib.contextmanager
def qtensor_act_fmt(fmt: Optional[str]):
    """``fmt`` for the QTensor matmuls inside the block."""
    _check_act_fmt(fmt)
    token = _ACT_FMT.set(fmt)
    try:
        yield
    finally:
        _ACT_FMT.reset(token)


def act_fmt_enabled() -> Optional[str]:
    return _ACT_FMT.get()


@dataclasses.dataclass(frozen=True, eq=False)
class QTensor:
    """Quantized out-major weight storage (see module docstring)."""

    codes: torch.Tensor          # int8 (..., N, K) | uint8 (..., N, K//2)
    scales: torch.Tensor         # f32 (..., 1, 1) | (..., N, K//bs)
    fmt_name: str = "int8"
    bits: int = 8
    block_k: int = -1            # -1 = per-tensor (per-matrix) scale

    @property
    def packed(self) -> bool:
        return self.bits == 4

    @property
    def in_dim(self) -> int:
        """K, the contraction axis length (unpacked)."""
        k = self.codes.shape[-1]
        return k * 2 if self.packed else k

    @property
    def out_dim(self) -> int:
        return self.codes.shape[-2]

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical stored (out-major, unpacked) shape (..., N, K)."""
        return tuple(self.codes.shape[:-1]) + (self.in_dim,)

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def layer(self, i: int) -> "QTensor":
        """The i-th matrix of a stacked (r, N, K) QTensor, as a 2-D view."""
        if self.codes.ndim != 3:
            raise ValueError(f"layer() needs stacked 3-D storage, got "
                             f"{self.codes.ndim}-D")
        return dataclasses.replace(self, codes=self.codes[i],
                                   scales=self.scales[i])

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scales=self.scales.to(device))

    def dequantize(self) -> torch.Tensor:
        """Dense fp32 matrix in the stored (..., N, K) orientation."""
        return dequant_t_ref(self.codes, self.scales, self.block_k,
                             self.packed)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Dequantized rows ``dense[idx]``: reads only the touched rows."""
        codes = self.codes[idx]
        scales = self.scales if self.block_k == -1 else self.scales[idx]
        return dequant_t_ref(codes, scales, self.block_k, self.packed)


def quantize_qtensor(stored: torch.Tensor, fmt, block_k: int = -1) -> QTensor:
    """Quantize an out-major matrix ``stored`` (..., N, K) into a QTensor:
    per-matrix absmax for ``block_k=-1``, else contiguous K-blocks."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    if not isinstance(fmt, IntFormat):
        raise ValueError(f"QTensor storage supports integer formats only, "
                         f"got {fmt!r}")
    if stored.ndim < 2:
        raise ValueError("QTensor wraps matrices (ndim >= 2)")
    stored = stored.to(torch.float32)
    k = stored.shape[-1]
    if block_k == -1:
        absmax = torch.amax(torch.abs(stored), dim=(-2, -1), keepdim=True)
        s = fmt.scale(absmax)                        # (..., 1, 1)
        codes = fmt.quantize_codes(stored, s)
        scales = s
    else:
        if k % block_k != 0:
            raise ValueError(f"K={k} not divisible by block_k={block_k}")
        blocked = stored.reshape(stored.shape[:-1] + (k // block_k, block_k))
        absmax = torch.amax(torch.abs(blocked), dim=-1, keepdim=True)
        s = fmt.scale(absmax)                        # (..., N, Kb, 1)
        codes = fmt.quantize_codes(blocked, s).reshape(stored.shape)
        scales = s[..., 0]                           # (..., N, Kb)
    if fmt.bits == 4:
        if k % 2 != 0:
            raise ValueError(f"int4 packing needs even K, got {k}")
        codes = _pack_last(codes)
    elif fmt.bits != 8:
        raise ValueError(f"unsupported storage width int{fmt.bits}")
    return QTensor(codes.contiguous(), scales.to(torch.float32).contiguous(),
                   fmt.name, fmt.bits, block_k)


def from_matmul_weight(w: torch.Tensor, fmt, block_k: int = -1) -> QTensor:
    """Quantize a dense ``x @ w`` operand ``w`` (..., K, N), stored
    transposed (out-major)."""
    return quantize_qtensor(w.transpose(-1, -2), fmt, block_k)


def matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x (..., K) @ dequant(qt)^T -> (..., N)``.  2-D storage: one
    ``wqt_matmul`` call over the flattened leading dims of x, or under
    ``act_fmt="int8"`` one ``wqt_matmul_a8_x`` call (the row quantization
    of x, the integer matmul and the cast to x's dtype).  3-D storage (an
    expert stack (E, N, K)) takes x (E, M, K) and makes that call once per
    expert, as JAX's ``lax.map`` does, with per-matrix scales broadcast
    over E when the stack has one -> (E, M, N) in x's dtype."""
    if qt.codes.ndim == 3:
        return _matmul_experts(x, qt)
    if qt.codes.ndim != 2:
        raise ValueError(f"unsupported QTensor rank {qt.codes.ndim}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _matmul_2d(x2, qt.codes, qt.scales, qt).reshape(
        lead + (qt.out_dim,))


def _matmul_2d(x2, codes, scales, qt: QTensor) -> torch.Tensor:
    if act_fmt_enabled() == "int8":
        return wqt_matmul_a8_x(x2, codes, scales, block_k=qt.block_k,
                               bits=qt.bits)
    return wqt_matmul(x2, codes, scales, block_k=qt.block_k, bits=qt.bits)


def _matmul_experts(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    e = qt.codes.shape[0]
    if x.ndim != 3 or x.shape[0] != e:
        raise ValueError(f"batched QTensor (E={e}) needs x of shape "
                         f"(E, M, K), got {tuple(x.shape)}")
    scales = qt.scales
    if qt.block_k == -1 and scales.shape[0] != e:
        scales = torch.broadcast_to(scales, (e,) + tuple(scales.shape[-2:]))
    outs = [_matmul_2d(x[i].contiguous(), qt.codes[i],
                       scales[i].contiguous(), qt) for i in range(e)]
    return torch.stack(outs)


# --------------------------------------------------------------------------
# Whole-tree conversion (the serving packer)
# --------------------------------------------------------------------------

MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
                 "vision_proj", "embed", "lm_head")

# leaves already stored out-major (the embedding table): quantized in place
_NATURAL_LEAVES = ("embed",)


def _convertible(last: str, x: torch.Tensor, fmt, block_k: int) -> bool:
    if last not in MATMUL_LEAVES:
        return False
    if not isinstance(fmt, IntFormat) or fmt.bits not in (4, 8):
        return False
    if x.ndim < 2 or x.ndim > 3:
        return False
    if last == "embed" and x.ndim != 2:
        return False
    k = x.shape[-1] if last in _NATURAL_LEAVES else x.shape[-2]
    if fmt.bits == 4 and k % 2 != 0:
        return False
    if block_k != -1 and k % block_k != 0:
        return False
    return True


def leaf_converter(fmt, block_size: int = -1, mode: str = "rtn",
                   uniforms: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   store: bool = True):
    """``leaf(path, x)``: what ``quantize_params`` (``store``) or
    ``cast_params`` makes of one eligible leaf (RR draws from
    ``generator`` on each call, so call it on the leaves in tree
    order)."""
    from ..kernels.quant import quant_rr, quant_rtn
    from .modes import leaf_uniforms
    if mode == "rr":
        if uniforms is None and generator is None:
            raise ValueError("RR cast needs uniforms or a generator")
    elif mode != "rtn":
        raise ValueError(f"mode {mode!r} not in ('rtn', 'rr')")
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt

    def rr(path, x):
        return quant_rr(x, leaf_uniforms(path, x, uniforms, generator),
                        fmt.name, block_size)

    def leaf(path, x):
        last = path_str(path).rsplit("/", 1)[-1]
        if store and _convertible(last, x, fmt, block_size):
            stored = x if last in _NATURAL_LEAVES else x.transpose(-1, -2)
            if mode == "rr":
                stored = rr(path, stored.to(torch.float32).contiguous())
            return quantize_qtensor(stored, fmt, block_size)
        if mode == "rr":
            return rr(path, x)
        return quant_rtn(x, fmt.name, block_size)

    return leaf


def quantize_params(params, fmt, policy: Optional[QuantPolicy] = None,
                    block_size: int = -1, mode: str = "rtn",
                    uniforms: Optional[Dict[str, torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None):
    """Convert eligible weight leaves to QTensor storage; eligible leaves
    that cannot become a QTensor (routers, 4-D expert stacks) get the
    dense RTN or RR cast through the ``quant`` kernel, the rest stay.

    ``mode="rr"`` casts a convertible leaf by unbiased randomized rounding
    IN THE STORED ORIENTATION, in fp32, through the ``quant`` kernel, and
    keeps its codes: on the stored matrix the cast's blocks are the
    QTensor's K-blocks and RR keeps each block's absmax, so re-quantizing
    the cast is the identity.  The uniforms of a leaf have the shape the
    cast sees (stored for convertible leaves, as given otherwise): from
    ``uniforms`` (``{path_str: tensor}``) or drawn from ``generator`` leaf
    by leaf in tree order.  A tree of blocks on a mesh:
    ``distributed.sharding.quantize_params_on_blocks``."""
    policy = policy if policy is not None else QuantPolicy()
    return policy.map_eligible(
        leaf_converter(fmt, block_size, mode, uniforms, generator), params)


def dequantize_params(params):
    """Every QTensor leaf becomes its dense dequantized matrix in the
    original (matmul operand) orientation."""
    def leaf(path, x):
        if not isinstance(x, QTensor):
            return x
        dense = x.dequantize()
        if path_str(path).rsplit("/", 1)[-1] in _NATURAL_LEAVES:
            return dense
        return dense.transpose(-1, -2)

    return tree_map_with_path(leaf, params)


def has_qtensor(params) -> bool:
    return any(isinstance(t, QTensor) for t in tree_leaves(params))


def param_nbytes(params) -> int:
    """Stored bytes of a parameter tree: QTensor leaves count codes +
    scales, dense leaves their tensor bytes."""
    return sum(t.nbytes if isinstance(t, QTensor)
               else t.numel() * t.element_size() for t in tree_leaves(params))
