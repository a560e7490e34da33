"""Move parameter trees and configs between the JAX package and the port,
through numpy.

The JAX side hands over ``jax.tree.map(np.asarray, params)``: a nested
dict of numpy arrays whose quantized leaves are QTensor objects holding
numpy ``codes``/``scales`` plus their static ``fmt_name``/``bits``/
``block_k``.  ``to_torch`` rebuilds the same tree as tensors on a device
(stacked ``(n_repeats, ...)`` leaves unchanged) and ``to_numpy`` goes
back; both are exact, bf16 included.  ``flatten`` keys a tree by
``path_str``, the key both packages' quantization rules read.  Nothing
here imports JAX: QTensors are recognized by their attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .core.policy import path_str, tree_map_with_path
from .core.qtensor import QTensor
from .models.lm import LMConfig

_QT_FIELDS = ("codes", "scales", "fmt_name", "bits", "block_k")


def _is_foreign_qtensor(x) -> bool:
    """A QTensor of the JAX package (by its attributes) or the plain dict
    that ``to_numpy`` makes of one."""
    if isinstance(x, dict):
        return set(x) == set(_QT_FIELDS)
    return not isinstance(x, QTensor) and all(hasattr(x, f)
                                              for f in _QT_FIELDS)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise TypeError("numpy has no bfloat16 dtype registered "
                            "(ml_dtypes not imported)") from None
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays (and numpy-backed QTensors) -> the
    port's nested dict of tensors (and QTensors) on ``device``."""
    def leaf(path, x):
        if _is_foreign_qtensor(x):
            f = x if isinstance(x, dict) else vars(x)
            return QTensor(_tensor(f["codes"], device),
                           _tensor(f["scales"], device), str(f["fmt_name"]),
                           int(f["bits"]), int(f["block_k"]))
        if isinstance(x, QTensor):
            return x.to(device)
        return _tensor(x, device)

    return tree_map_with_path(leaf, tree, is_leaf=_is_foreign_qtensor)


def to_numpy(tree):
    """The port's tree -> nested dict of numpy arrays; a QTensor becomes a
    plain dict of its five fields (numpy codes/scales)."""
    def leaf(path, x):
        if isinstance(x, QTensor):
            return {"codes": _array(x.codes), "scales": _array(x.scales),
                    "fmt_name": x.fmt_name, "bits": x.bits,
                    "block_k": x.block_k}
        return _array(x)

    return tree_map_with_path(leaf, tree)


def flatten(tree) -> Dict[str, Any]:
    """``{path_str: leaf}`` over a nested dict (QTensors are leaves)."""
    out: Dict[str, Any] = {}

    def leaf(path, x):
        out[path_str(path)] = x

    tree_map_with_path(leaf, tree, is_leaf=_is_foreign_qtensor)
    return out


def lm_config(other) -> LMConfig:
    """The port's LMConfig from any dataclass with the same field names
    (the JAX LMConfig); a non-torch ``dtype`` is carried by name."""
    kw = {f.name: getattr(other, f.name) for f in dataclasses.fields(LMConfig)}
    if not isinstance(kw["dtype"], torch.dtype):
        kw["dtype"] = np.dtype(kw["dtype"]).name
    return LMConfig(**kw)
