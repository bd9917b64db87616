"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``):
each returns ``f(step) -> fp32 tensor``."""

from __future__ import annotations

import math

import torch


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def constant_lr(lr: float):
    return lambda step: _t(lr)


def cosine_lr(lr: float, total_steps: int, min_ratio: float = 0.1):
    def f(step):
        t = torch.clamp(_t(step) / max(total_steps, 1), 0.0, 1.0)
        return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, min_ratio: float = 0.1):
    cos = cosine_lr(lr, max(total_steps - warmup, 1), min_ratio)

    def f(step):
        w = torch.clamp(_t(step) / max(warmup, 1), 0.0, 1.0)
        return torch.where(_t(step) < warmup, lr * w, cos(_t(step) - warmup))
    return f
