"""LR schedules (port of ``repro.optim.schedule``): cosine and WSD
(warmup-stable-decay, minicpm's schedule).  Each returns a 0-dim f32 tensor,
on ``step``'s device when ``step`` is a tensor, with JAX's f32 arithmetic in
JAX's order."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine(step, *, peak_lr: float, total_steps: int, warmup_steps: int = 100,
           min_ratio: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clip((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr: float, total_steps: int, warmup_steps: int = 100,
        decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup -> stable (constant) -> exponential-ish linear decay tail."""
    step = _f32(step)
    decay_steps = torch.tensor(max(total_steps * decay_frac, 1), dtype=torch.float32,
                               device=step.device)
    decay_start = total_steps - decay_steps
    warm = peak_lr * step / max(warmup_steps, 1)
    tail_frac = torch.clip((step - decay_start) / decay_steps, 0, 1)
    tail = peak_lr * (min_ratio ** tail_frac)  # exponential decay tail
    stable = torch.full_like(step, peak_lr)
    return torch.where(step < warmup_steps, warm, torch.where(step < decay_start, stable, tail))


def make(name: str, **kw):
    fn = {"cosine": cosine, "wsd": wsd}[name]
    return lambda step: fn(step, **kw)
