"""Composable update transforms (port of ``repro.optim.transform``):
optax-style ``init``/``update`` pairs over nested dicts of tensors.

The train step is one chain ``clip -> [lotion_decoupled] -> core``, so the
LOTION penalty runs outside global-norm clipping and once per step outside
the microbatch loop (DESIGN.md §2).  Conventions, as in the JAX package:

* ``update(updates, state, params=None, **extras) -> (updates, state)``;
  ``extras`` carries ``fisher=`` (the pre-update Fisher diagonal),
  ``step_ok=`` and ``lr_scale=``.
* Updates keep the gradient sign until the terminal core, which emits the
  (negative) step that ``apply_updates`` adds.  A terminal core with
  ``applies_updates=True`` (the fused step kernel) emits NEW PARAMETERS;
  the train step then skips ``apply_updates``.
* Chain state is a tuple of link states.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from ..core.policy import tree_map


def _no_fisher(state) -> None:
    return None


@dataclasses.dataclass(frozen=True)
class UpdateTransform:
    """An optax-style (init, update) pair.

    ``fisher`` maps the state to the empirical-Fisher diagonal it tracks
    (or None); ``applies_updates`` marks a terminal core that writes new
    parameters; ``meta`` exposes a core's hyperparameters so
    ``make_optimizer`` can rebuild it as the fused core."""

    init: Callable                      # params -> state
    update: Callable                    # (updates, state, params=None, **extras)
    fisher: Callable = _no_fisher       # state -> fisher tree | None
    links: Optional[Tuple] = None       # set by chain(); None for leaf transforms
    tag: Optional[str] = None           # identity marker for chain validation
    applies_updates: bool = False       # update() returns new params, not a step
    meta: Optional[dict] = None         # core hyperparameters (introspection)


def chain(*transforms: UpdateTransform) -> UpdateTransform:
    """Compose transforms left-to-right; state is the tuple of link states.
    A transform with ``applies_updates=True`` may only be the last link."""
    for t in transforms[:-1]:
        if t.applies_updates:
            raise ValueError(
                "a transform with applies_updates=True writes new params "
                "and must be the LAST link of a chain")

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None, **extras):
        if not isinstance(state, (tuple, list)) or len(state) != len(transforms):
            raise ValueError(
                f"chain of {len(transforms)} links expects a state tuple of "
                f"the same length, got {type(state).__name__} — was the "
                f"state initialized with this chain?")
        new_states = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params, **extras)
            new_states.append(s)
        return updates, tuple(new_states)

    def fisher(state):
        for t, s in zip(transforms, state):
            f = t.fisher(s)
            if f is not None:
                return f
        return None

    return UpdateTransform(init=init, update=update, fisher=fisher,
                           links=tuple(transforms),
                           applies_updates=transforms[-1].applies_updates)


def identity() -> UpdateTransform:
    """The do-nothing transform."""
    return UpdateTransform(
        init=lambda params: (),
        update=lambda updates, state, params=None, **_: (updates, state))


def apply_updates(params, updates):
    """``params + updates`` leafwise (the terminal core emits negative steps)."""
    return tree_map(lambda p, u: p + u, params, updates)


def as_transform(opt: Any) -> UpdateTransform:
    """An ``UpdateTransform`` passes through; an ``Optimizer`` wrapper
    contributes its core (``.transform``)."""
    if isinstance(opt, UpdateTransform):
        return opt
    core = getattr(opt, "transform", None)
    if isinstance(core, UpdateTransform):
        return core
    raise TypeError(f"expected an UpdateTransform or an Optimizer wrapper, "
                    f"got {type(opt).__name__}")
