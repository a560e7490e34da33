"""Optimizers of the port (``repro.optim``): the composable update-transform
chain, AdamW/SGD cores with ``Optimizer`` wrappers, schedules, clipping,
the decoupled LOTION link and the fused single-pass cores."""

from .adamw import Optimizer, adamw, adamw_core, sgd, sgd_core
from .clip import clip_by_global_norm, clip_global_norm, global_norm
from .fused import fused_lotion_adamw_core, fused_lotion_sgd_core
from .lotion import lotion_decoupled
from .schedule import constant, cosine_with_warmup, linear_warmup
from .transform import (UpdateTransform, apply_updates, as_transform, chain,
                        identity)

__all__ = ["Optimizer", "adamw", "adamw_core", "sgd", "sgd_core",
           "cosine_with_warmup", "constant", "linear_warmup",
           "clip_by_global_norm", "clip_global_norm", "global_norm",
           "UpdateTransform", "chain", "apply_updates", "as_transform",
           "identity", "lotion_decoupled", "fused_lotion_adamw_core",
           "fused_lotion_sgd_core"]
