"""LR schedules: functions of the step counter (the JAX package's
``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, warmup: int, total: int, floor: float = 0.1
                  ) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak: the
    multiplicative scale in [0, 1] as a float32 tensor (on ``step``'s
    device when ``step`` is a tensor)."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(float(step))
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
