"""Placement context of the model code (``repro.distributed.context``).

The model code does not know the mesh: the sharded train step installs,
for well-known roles, what the model applies where it reads a tensor,
and the model applies it through ``constrain`` / ``constrain_tree``.
With nothing installed (tests, one device, serving) every call is a
no-op, as in JAX.

Roles the model applies (``models/lm.py``): ``residual`` (b, l, d)
carried through the layers, ``head_in``, ``logits``, ``stage_params``
(one unit's slice of the stacked stage leaves, inside the layer loop and
so inside its recomputation under ``cfg.remat``), and the unstacked
leaves where ``_embed``, ``_head``, ``image_context`` and the shared
block read them: ``embed``, ``lm_head``, ``final_norm_scale``,
``vision_proj``, ``shared``.  JAX installs ``NamedSharding``s, and
``with_sharding_constraint`` places the value; the port installs a
function per tensor (``sharding.gather_at_use`` bound to the leaf's
sharding: the full leaf where it is read, its gradient back to the
rank's block), or for a tree a tree of them.

Serving installs the parameter roles only (``sharding.serve_roles``:
gathers without autograd, a QTensor's codes and scales each by its own
sharding); ``constraints`` installs roles for a block and puts back what
was installed before, so that a server nested in another (the
scheduler's fallback engine) leaves its caller's roles in place.

``set_cost_mode`` / ``scan_unroll`` are JAX's flag and function, kept so
that code written against either package reads the same: XLA counts a
while-loop body once, and the JAX dry-run unrolls its scans to count
every trip.  The port's layer loops are Python loops, traced once per
trip, so nothing here reads the flag to unroll, and ``scan_unroll``
only reports what JAX would pass.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

_CONSTRAINTS: Dict[str, object] = {}
_COST_MODE: list = [False]


def set_cost_mode(on: bool) -> None:
    """JAX's cost-accounting flag (see the module docstring)."""
    _COST_MODE[0] = bool(on)


def scan_unroll(length: int) -> int:
    """The ``unroll=`` JAX's model scans take under cost mode."""
    return length if _COST_MODE[0] else 1


def set_constraints(**kwargs) -> None:
    _CONSTRAINTS.clear()
    _CONSTRAINTS.update({k: v for k, v in kwargs.items() if v is not None})


def clear_constraints() -> None:
    _CONSTRAINTS.clear()


@contextlib.contextmanager
def constraints(**kwargs):
    """``kwargs`` installed for the block; the roles installed before it
    come back after it."""
    saved = dict(_CONSTRAINTS)
    set_constraints(**kwargs)
    try:
        yield
    finally:
        _CONSTRAINTS.clear()
        _CONSTRAINTS.update(saved)


def constrain(x, role: str):
    fn = _CONSTRAINTS.get(role)
    if fn is None:
        return x
    return fn(x)


def constrain_tree(tree, role: str):
    """Apply a tree of per-leaf functions (the role's) to a tree of the
    same structure (nested dicts)."""
    fns = _CONSTRAINTS.get(role)
    if fns is None:
        return tree
    return _map(tree, fns)


def _map(tree, fns):
    if isinstance(tree, dict):
        return {k: _map(v, fns[k]) for k, v in tree.items()}
    f: Callable = fns
    return f(tree)
