"""LR schedules: the counterpart of `repro/optim/schedule.py`."""
import math

import torch


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """``lr(step)``: linear warm-up over `warmup` steps, then a cosine from
    `peak_lr` down to ``floor * peak_lr`` at `total`; the step comes in as
    a tensor (the optimiser's int32 count) and the math is float32."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
