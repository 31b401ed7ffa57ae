"""LR schedules: cosine (default) and WSD (warmup-stable-decay, MiniCPM).

Port of ``repro.optim.schedules``: each schedule is evaluated in float32,
as the reference's ``jnp`` arithmetic is, and returns a 0-dim float32
tensor on the step's device (the CPU for a Python int).
"""

from __future__ import annotations

import math

import torch


def make_schedule(kind: str, total_steps: int, warmup: int = 100,
                  decay_frac: float = 0.1, min_ratio: float = 0.1):
    """Returns step -> lr multiplier in [0, 1]."""

    def cosine(step):
        step = torch.as_tensor(step).to(torch.float32)
        w = torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return w * cos

    def wsd(step):
        """MiniCPM warmup-stable-decay: flat LR, then a short sharp decay tail."""
        step = torch.as_tensor(step).to(torch.float32)
        w = torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        decay_start = total_steps * (1.0 - decay_frac)
        t = torch.clamp((step - decay_start) / max(total_steps - decay_start, 1),
                        0.0, 1.0)
        stable = torch.where(step < decay_start, 1.0, 1.0 - (1.0 - min_ratio) * t)
        return w * stable

    return {"cosine": cosine, "wsd": wsd}[kind]
