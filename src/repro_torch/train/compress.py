"""Error-feedback int8 gradient compression (port of
``repro.train.compress``).

Each step casts (gradient + carried error) to blockwise int8, RTN, and
feeds the residual back into the next step (Seide et al. 2014, EF-SGD):
what a data-parallel all-reduce would carry is the int8 codes and a
scale per block.  The cast is the ``quant`` kernel (``kernels.quant.
quant_rtn`` at ``"int8"`` and the block size: one launch per gradient
leaf on the card, the plain version for CPU tensors).  The port runs on
one device, so nothing crosses a wire: this module gives the value
semantics (the update sees the dequantized compressed gradient) and the
wire-format accounting.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.formats import INT8, bits_of
from ..core.policy import (tree_leaves, tree_map, tree_map_multi,
                           tree_map_with_path)
from ..kernels.quant import quant_rtn
from ..optim.transform import UpdateTransform


def ef_compress(grads, err, block_size: int = 256) -> Tuple:
    """``(compressed_grads, new_err)``: the dequantized int8 cast of
    ``grads + err`` and its residual."""
    def one(g, e):
        corrected = g + e
        q = quant_rtn(corrected, "int8", block_size)
        return q, corrected - q

    pairs = tree_map_multi(lambda path, g, e: one(g, e), grads, err)
    return (tree_map_with_path(lambda path, p: p[0], pairs),
            tree_map_with_path(lambda path, p: p[1], pairs))


def ef_transform(block_size: int = 256) -> UpdateTransform:
    """Chain link for :func:`ef_compress`; the carried error lives in the
    link's state (``{"err": ...}``), so it checkpoints with the rest of
    the optimizer state."""

    def init(params):
        return {"err": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None, **_):
        compressed, err = ef_compress(updates, state["err"], block_size)
        return compressed, {"err": err}

    return UpdateTransform(init=init, update=update, tag="ef_compress")


def wire_bytes(grads, block_size: int = 256) -> int:
    """Bytes a compressed all-reduce would carry (int8 codes + fp16
    scales)."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        n_blocks = -(-n // block_size)
        total += n * int(bits_of(INT8)) // 8 + n_blocks * 2
    return total
