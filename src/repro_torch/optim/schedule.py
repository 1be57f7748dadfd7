"""LR schedules as pure functions of the step (the JAX package's
``optim/schedule.py``): the step is an int or a 0-d tensor, the arithmetic
f32, and the result a 0-d f32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_linear(base_lr: float, warmup_steps: int):
    def fn(step):
        s = _step(step)
        return base_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)

    return fn


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                    min_ratio: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos

    return fn
