"""Train state (port of ``repro.train.state``): a plain dict of the
parameter tree, the optimizer state and the step counter, all on the
parameters' device.  Build the optimizer chain ONCE
(``make_optimizer``) and pass the same object here and to
``make_train_step``, so the state structures agree."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.policy import tree_leaves


def init_state(params, optimizer, lr_scale: bool = False) -> Dict[str, Any]:
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if lr_scale:
        # the spike-cooldown LR multiplier, as a device scalar
        state["lr_scale"] = torch.ones((), dtype=torch.float32, device=dev)
    return state
