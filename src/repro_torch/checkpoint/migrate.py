"""Optimizer-state migration between the fused core's flat dict and the
unfused chain's tuple of link states (port of
``repro.checkpoint.migrate``).

The fused core (``optim/fused.py``) keeps ``{"mu", "nu", "count",
"gnorm"[, "penalty"]}``; the chain keeps a tuple of per-link dicts, e.g.
``({"gnorm"}, {"penalty"}, {"mu", "nu", "count"})``.  Both use the same
reserved key names, so migration is a key-matched copy into the target
template: no arithmetic, hence bit-exact resume::

    like = init_state(params, make_optimizer(tcfg, adamw(lr)))
    saved, step = ckpt.load(ckpt_dir, saved_like)
    saved["opt"] = migrate_opt_state(saved["opt"], like["opt"])

EF compression is chain-only: a chain state carrying an ``err`` tree
does not migrate into the fused layout.
"""

from __future__ import annotations

from typing import Any, Dict

from .io import _leaf_shape, _paths_and_leaves

# the reserved state keys both layouts share
_SHARED_KEYS = ("mu", "nu", "count", "gnorm", "penalty")


def opt_state_kind(opt_state) -> str:
    """``"chain"`` (tuple of link dicts) or ``"fused"`` (flat dict)."""
    if isinstance(opt_state, (tuple, list)):
        return "chain"
    if isinstance(opt_state, dict):
        return "fused"
    raise ValueError(f"unrecognized optimizer state: {type(opt_state)!r}")


def _links(opt_state):
    return (list(opt_state) if isinstance(opt_state, (tuple, list))
            else [opt_state])


def _collect(opt_state) -> Dict[str, Any]:
    """Either layout as one {reserved key: value} dict."""
    found: Dict[str, Any] = {}
    for link in _links(opt_state):
        if not isinstance(link, dict):
            continue
        for k in _SHARED_KEYS + ("err",):
            if k in link:
                if k in found:
                    raise ValueError(
                        f"optimizer state holds {k!r} in more than one "
                        f"link — cannot migrate unambiguously")
                found[k] = link[k]
    return found


def migrate_opt_state(opt_state, like):
    """Re-layout ``opt_state`` into the structure of ``like`` (the target
    optimizer's ``init(params)``).  Every reserved key present in both is
    copied across (the same tensors); target keys absent from the source
    keep the template's value.  Raises if the source holds state the
    target cannot (EF ``err``, or mu/nu/count of another optimizer), or if
    a parameter-shaped tree disagrees in structure or shape."""
    src = _collect(opt_state)
    dst_keys = set(_collect(like))
    # only step metrics (gnorm/penalty) may drop silently; losing mu, nu,
    # count or the EF error would wipe optimizer memory on "resume"
    if "err" in src and "err" not in dst_keys:
        raise ValueError(
            "source optimizer state carries an EF-compression error tree "
            "('err') but the target layout has no EF link — the fused "
            "core cannot represent it (DESIGN.md §5)")
    lost = sorted(k for k in src
                  if k not in dst_keys and k not in ("gnorm", "penalty"))
    if lost:
        raise ValueError(
            f"target optimizer layout has no slot for load-bearing state "
            f"{lost} — migrate between layouts of the SAME update rule "
            f"(chain-tuple <-> fused-dict AdamW), not across optimizers")

    def fill(link_like):
        if not isinstance(link_like, dict):
            return link_like
        out = {}
        for k, v in link_like.items():
            if k in src:
                _check_like(src[k], v, k)
                out[k] = src[k]
            else:
                out[k] = v
        return out

    if isinstance(like, (tuple, list)):
        return type(like)(fill(link) for link in like)
    return fill(like)


def _check_like(value, like, key: str) -> None:
    v_items, l_items = _paths_and_leaves(value), _paths_and_leaves(like)
    v_def, l_def = [k for k, _ in v_items], [k for k, _ in l_items]
    if v_def != l_def:
        raise ValueError(
            f"optimizer-state key {key!r} has tree structure {v_def} in "
            f"the source but {l_def} in the target — migrate between "
            f"optimizers over the SAME parameter tree")
    for (_, v), (_, l) in zip(v_items, l_items):
        if tuple(_leaf_shape(v)) != tuple(_leaf_shape(l)):
            raise ValueError(
                f"optimizer-state key {key!r}: leaf shape "
                f"{tuple(_leaf_shape(v))} vs target "
                f"{tuple(_leaf_shape(l))}")
