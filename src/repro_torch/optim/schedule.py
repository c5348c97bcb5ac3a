"""LR schedules — the port of the JAX package's ``optim/schedule.py``:
float32 tensor arithmetic, as there, so that the rates agree."""
import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``floor_frac * peak_lr`` at ``total``.  ``step``: an integer tensor
    (the optimizer's) or int; returns a float32 scalar tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
