"""Shape and dtype specs of the port's inputs and states
(``repro.launch.specs``), on the meta device.

Nothing here allocates: parameters, optimizer state and caches come from
the init functions run on the ``meta`` device (``lm_init`` draws nothing
there), batches are meta tensors.  The sharding rules read them at any
size, a 156 GB Llama-3.2-Vision state or DBRX included.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, get_config
from ..models.lm import LMConfig, init_cache, lm_init
from ..optim import adamw, cosine_with_warmup
from ..train import TrainConfig, init_state, make_optimizer

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage (JAX's ShapeDtypeStruct)."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: LMConfig, batch: int, seq: int) -> Dict[str, Any]:
    tok_shape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks > 1
                 else (batch, seq))
    specs = {"tokens": sds(tok_shape, torch.int32),
             "labels": sds(tok_shape, torch.int32)}
    if cfg.n_image_tokens:
        specs["image_embeds"] = sds(
            (batch, cfg.n_image_tokens, cfg.d_vision), torch.bfloat16)
    return specs


def state_specs(cfg: LMConfig, tcfg: Optional[TrainConfig] = None):
    """Abstract train state (params + optimizer state + step).  The
    optimizer's structure depends on the train config (EF compression,
    the decoupled-LOTION link, the fused core), so pass the ``tcfg`` the
    step will use; the default matches ``make_train_step``'s for a plain
    ``TrainConfig()``."""
    tx = make_optimizer(tcfg if tcfg is not None else TrainConfig(),
                        adamw(cosine_with_warmup(1e-3, 100, 10000)))
    return init_state(lm_init(cfg, device=META), tx)


def params_specs(cfg: LMConfig):
    return lm_init(cfg, device=META)


def decode_specs(cfg: LMConfig, batch: int, seq: int,
                 kv_quant=False) -> Dict[str, Any]:
    cache = init_cache(cfg, batch, seq, kv_quant=kv_quant, device=META)
    tok_shape = ((batch, 1, cfg.n_codebooks) if cfg.n_codebooks > 1
                 else (batch, 1))
    return {
        "cache": cache,
        "tokens": sds(tok_shape, torch.int32),
        "pos": sds((batch,), torch.int32),
    }


def input_specs(arch: str, shape_id: str, kv_quant=False):
    """Returns (cfg, kind, specs-dict) for one cell of ``configs.SHAPES``."""
    cfg = get_config(arch)
    sh = SHAPES[shape_id]
    b, l, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    if kind == "train":
        return cfg, kind, train_batch_specs(cfg, b, l)
    if kind == "prefill":
        specs = {"tokens": sds(
            (b, l, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, l),
            torch.int32)}
        if cfg.n_image_tokens:
            specs["image_embeds"] = sds(
                (b, cfg.n_image_tokens, cfg.d_vision), torch.bfloat16)
        return cfg, kind, specs
    if kind == "decode":
        return cfg, kind, decode_specs(cfg, b, l, kv_quant=kv_quant)
    raise ValueError(kind)
