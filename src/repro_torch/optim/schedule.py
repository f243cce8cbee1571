"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def cosine_with_warmup(step, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.learning_rate`` over ``warmup_steps``, then
    a cosine to 0 at ``total_steps``: a float32 0-d tensor on ``step``'s
    device (``step``: an int or a tensor)."""
    step = torch.as_tensor(step).float()
    warm = cfg.learning_rate * torch.clamp(
        step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.learning_rate * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)
