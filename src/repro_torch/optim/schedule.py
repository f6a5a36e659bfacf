"""LR schedules (port of ``repro.optim.schedule``): pure functions of the
step counter, in f32 on the counter's device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int = 200,
                    total: int = 10_000, floor_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``floor_frac * peak_lr`` at ``total``.  ``step`` is an int or a tensor
    (the optimizer's ``step``); the result is a 0-dim f32 tensor on its
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(1, warmup), max=1.0)
    t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)
