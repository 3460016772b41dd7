"""LR schedules: linear warmup + {cosine, WSD}.

The PyTorch counterpart of ``repro/optim/schedule.py``.  WSD
(warmup-stable-decay) is the schedule minicpm-2b trains with
[arXiv:2404.06395]: linear warmup, long stable plateau, then a sharp
decay tail.  A step is an int or an integer tensor (on any device); the
rate is a 0-d float32 tensor on the step's device, computed in f32 as
the reference computes it.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    step = _step(step)
    return peak * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine(step, *, peak: float, warmup_steps: int, total_steps: int,
           final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak * cos)


def wsd(step, *, peak: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> stable plateau -> sharp (exponential) decay tail."""
    step = _step(step)
    warm = linear_warmup(step, warmup_steps, peak)
    decay_start = total_steps * (1.0 - decay_frac)
    t = torch.clamp((step - decay_start)
                    / max(total_steps - decay_start, 1), 0.0, 1.0)
    decayed = peak * torch.exp(
        torch.tensor(math.log(final_frac), dtype=torch.float32) * t)
    plateau = torch.full_like(decayed, peak)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < decay_start, plateau, decayed))


SCHEDULES = {"cosine": cosine, "wsd": wsd}


def make(name: str, **kw):
    fn = SCHEDULES[name]
    return lambda step: fn(step, **kw)
