"""Learning-rate schedules: functions of the step counter (a device int
tensor) that return a 0-d fp32 tensor on its device, so the schedule
never syncs with the host."""

from __future__ import annotations

import numpy as np
import torch

from ..numerics import div_scalar


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return f


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        frac = torch.clamp(div_scalar(_f32(step), max(warmup_steps, 1)),
                           max=1.0)
        return lr * frac
    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    """Linear warmup then cosine decay to ``final_frac * lr`` (the paper's
    cosine scheduler)."""
    def f(step):
        step = _f32(step)
        warm = div_scalar(step, max(warmup_steps, 1))
        prog = torch.clamp(div_scalar(step - warmup_steps,
                                      max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(np.pi * prog))
        return lr * torch.where(step < warmup_steps, warm, cos)
    return f
