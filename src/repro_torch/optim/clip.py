"""Global-norm gradient clipping (function + chainable transform)."""

from __future__ import annotations

import torch

from ..core.policy import tree_leaves, tree_map
from .transform import UpdateTransform


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, in fp32, on the device
    (no host sync).  With ``shardings`` the leaves are blocks: each
    block's sum of squares counts once (on the one replica that owns it),
    the sum runs over every rank, then the square root."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in tree_leaves(tree)))
    from ..distributed import collectives
    from ..distributed.sharding import mesh_of, owns
    terms = [torch.sum(torch.square(x.to(torch.float32)))
             for x, s in zip(tree_leaves(tree), tree_leaves(shardings))
             if owns(s)]
    total = (sum(terms) if terms else torch.zeros(
        (), dtype=torch.float32, device=tree_leaves(tree)[0].device))
    mesh = mesh_of(shardings)
    return torch.sqrt(collectives.all_reduce(total, "sum", mesh,
                                             mesh.axis_names))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The global-norm clip multiplier, exactly 1.0 at ``max_norm=inf``.
    Shared by the chain link and the fused step kernel.  The numerator is
    a tensor: PyTorch computes ``number / tensor`` as a reciprocal times
    the number, JAX as one division."""
    num = torch.full_like(norm, max_norm)
    return torch.clamp(num / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float, shardings=None):
    norm = global_norm(tree, shardings)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def clip_global_norm(max_norm: float) -> UpdateTransform:
    """Chain link for :func:`clip_by_global_norm`; keeps the pre-clip norm
    in state under ``"gnorm"`` for the metrics."""

    def init(params):
        dev = tree_leaves(params)[0].device
        return {"gnorm": torch.zeros((), dtype=torch.float32, device=dev)}

    def update(updates, state, params=None, shardings=None, **_):
        clipped, norm = clip_by_global_norm(updates, max_norm, shardings)
        return clipped, {"gnorm": norm}

    return UpdateTransform(init=init, update=update)
