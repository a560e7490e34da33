"""Quantization policy: which parameters are quantization-eligible (port
of ``repro.core.policy``), over the port's nested-dict parameter trees.

Paths are tuples of dict keys; ``path_str`` joins them as ``'a/b/c'``
lowercased, exactly as the JAX helper renders a pytree KeyPath, so both
packages agree on the eligible set and on every rule keyed by the name.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Sequence

_DEFAULT_EXCLUDE = (
    "norm", "scale", "bias", "softcap",
    "a_log", "dt_bias", "decay", "bonus", "mu",  # mamba2 / rwkv6 / zamba dynamics
    "rope", "inv_freq",
)

_EMBED_HINTS = ("embed", "wte", "tok_", "lm_head", "codebook_emb", "head_")


def path_str(path: Sequence[Any]) -> str:
    """Tuple of keys -> 'a/b/c' string."""
    return "/".join(str(p) for p in path).lower()


def tree_map_with_path(fn: Callable, tree, path=(), is_leaf=None):
    """Map ``fn(path, leaf)`` over a nested dict; ``path`` is the tuple of
    keys.  ``is_leaf(x)`` may stop the descent at a non-dict node."""
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        return {k: tree_map_with_path(fn, v, path + (k,), is_leaf)
                for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree, is_leaf=None) -> list:
    out = []
    tree_map_with_path(lambda p, x: out.append(x), tree, is_leaf=is_leaf)
    return out


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Predicate over (param path, tensor)."""

    include_embeddings: bool = False
    min_ndim: int = 2
    min_size: int = 1024           # don't bother with tiny tensors
    exclude_patterns: tuple = _DEFAULT_EXCLUDE
    include_regex: Optional[str] = None   # overrides everything when set

    def eligible(self, path, x) -> bool:
        name = path_str(path)
        if self.include_regex is not None:
            return re.search(self.include_regex, name) is not None
        if x.ndim < self.min_ndim or x.numel() < self.min_size:
            return False
        if any(pat in name for pat in self.exclude_patterns):
            return False
        if not self.include_embeddings and any(h in name for h in _EMBED_HINTS):
            return False
        return True

    def map_eligible(self, fn: Callable, params):
        """Map ``fn(path, x)`` over eligible leaves, identity elsewhere."""
        return tree_map_with_path(
            lambda p, x: fn(p, x) if self.eligible(p, x) else x, params)
