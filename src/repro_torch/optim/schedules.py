"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM's).

Port of ``repro/optim/schedules.py``.  ``lr(step)`` takes a Python int
or an int tensor (the optimizer's device step counter) and computes in
float32 on the step's device, as ``jnp.asarray(step, float32)`` does,
so reading the lr inside a train step never copies to the host.
"""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int,
                 min_ratio: float = 0.01):
    """Warmup-Stable-Decay (arXiv:2404.06395): flat LR, then a short
    exponential decay tail."""
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * step / max(warmup, 1)
        in_decay = step > (warmup + stable)
        dprog = torch.clamp((step - warmup - stable) / max(decay, 1),
                            0.0, 1.0)
        dec = base_lr * torch.pow(min_ratio, dprog)
        return torch.where(step < warmup, warm,
                           torch.where(in_decay, dec, base_lr))
    return lr
