"""Learning-rate schedules as plain functions of the step (counterpart of
``repro.optim.schedule``): the step may be a Python number or a tensor,
and the result is a float32 tensor on the step's device (the CPU for a
number)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def linear_warmup(step, *, base_lr: float, warmup_steps: int
                  ) -> torch.Tensor:
    """``base_lr`` scaled by ``min(1, (step + 1) / warmup_steps)``."""
    s = _step(step)
    return base_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warm-up, then a cosine decay from ``base_lr`` to ``min_ratio
    * base_lr`` at ``total_steps``."""
    s = _step(step)
    warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
