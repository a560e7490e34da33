"""Error-feedback int8 gradient compression (port of
``repro.train.compress``).

Each step casts (gradient + carried error) to blockwise int8, RTN, and
feeds the residual back into the next step (Seide et al. 2014, EF-SGD):
what a data-parallel all-reduce would carry is the int8 codes and a
scale per block.  The cast is the ``quant`` kernel (``kernels.quant.
quant_rtn`` at ``"int8"`` and the block size: one launch per gradient
leaf on the card, the plain version for CPU tensors).  This module gives
the value semantics (the update sees the dequantized compressed
gradient) and the wire-format accounting.

On a mesh (``shardings``) the gradients and the error are the rank's
blocks, the gradients already summed over the data ranks.  A block that
holds whole quant blocks of its leaf (``sharding.whole_blocks``) is cast
where it lies; a leaf whose cut splits quant blocks is gathered whole
(gradient plus error), cast, and cut back to the rank's block.  Either
way each element's code is the one-device cast's, bitwise, and each
leaf is one ``quant`` launch.  ``GATHERED`` counts the leaves cast
whole, by path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.formats import INT8, bits_of
from ..core.policy import (path_str, tree_leaves, tree_map, tree_map_multi,
                           tree_map_with_path)
from ..distributed import sharding as shd
from ..kernels.quant import quant_rtn
from ..optim.transform import UpdateTransform

# leaf path -> casts of the whole gathered leaf (a mesh cut that splits
# quant blocks), since the last reset_gathered()
GATHERED: Dict[str, int] = {}


def reset_gathered() -> None:
    GATHERED.clear()


def _cast(corrected: torch.Tensor, s, block_size: int, path) -> torch.Tensor:
    """The int8 RTN cast of ``corrected`` (with ``s``: the rank's block
    of the full leaf's cast)."""
    full = shd.global_shape(s, corrected.shape)
    if shd.whole_blocks(full, s, block_size):
        return quant_rtn(corrected, "int8", block_size)
    name = path_str(path)
    GATHERED[name] = GATHERED.get(name, 0) + 1
    return shd.shard(quant_rtn(shd.gather(corrected, s), "int8", block_size),
                     s)


def ef_compress(grads, err, block_size: int = 256, shardings=None) -> Tuple:
    """``(compressed_grads, new_err)``: the dequantized int8 cast of
    ``grads + err`` and its residual; with ``shardings`` on the rank's
    blocks (module docstring)."""
    def one(path, g, e, s=None):
        corrected = g + e
        q = _cast(corrected, s, block_size, path)
        return q, corrected - q

    pairs = tree_map_multi(one, grads, err,
                           *(() if shardings is None else (shardings,)))
    return (tree_map_with_path(lambda path, p: p[0], pairs),
            tree_map_with_path(lambda path, p: p[1], pairs))


def ef_transform(block_size: int = 256) -> UpdateTransform:
    """Chain link for :func:`ef_compress`; the carried error lives in the
    link's state (``{"err": ...}``), so it checkpoints with the rest of
    the optimizer state."""

    def init(params):
        return {"err": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None, shardings=None, **_):
        compressed, err = ef_compress(updates, state["err"], block_size,
                                      shardings)
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
