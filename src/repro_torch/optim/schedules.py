"""LR schedules: cosine and WSD (warmup-stable-decay, the minicpm schedule).

The port of the JAX package's ``optim/schedules.py``. Each schedule is a
function of the step (an int or an integer tensor) that returns a 0-d
float32 tensor, computed in float32 as JAX computes it (the step cast to
float32, then ``cos`` / ``exp`` in float32; Python constants such as
``log(floor)`` are rounded to float32 where they meet the step).
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "wsd"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return fn


def wsd(peak: float, warmup: int, stable: int, decay: int,
        floor: float = 0.01):
    """MiniCPM's warmup-stable-decay: linear warmup, flat plateau, then an
    exponential-ish decay tail — enables continued pretraining from the
    plateau (arXiv:2404.06395)."""

    def fn(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        tail = peak * torch.exp(math.log(max(floor, 1e-8)) * t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, peak), tail))

    return fn
