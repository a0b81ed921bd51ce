"""LR schedules: functions of the step, as 0-d fp32 tensors (the JAX
package computes them in float32 too)."""
from __future__ import annotations

import math

import torch


def _step(step):
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, *, peak, warmup_steps):
    step = _step(step)
    return peak * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, peak, warmup_steps, total_steps, floor=0.1):
    step = _step(step)
    warm = linear_warmup(step, peak=peak, warmup_steps=warmup_steps)
    frac = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, peak * cos)
