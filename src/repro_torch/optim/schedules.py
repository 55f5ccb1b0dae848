"""LR schedules (port of ``repro.optim.schedules``): linear warmup + cosine
decay (the GPT-2 recipe), linear warmup + polynomial decay (the MLPerf
BERT recipe used with LAMB) and a constant. Each maps the optimizer step
(a 0-d tensor) to a float32 0-d tensor, computed in float32 as the JAX
package does."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (end_lr_frac + (1 - end_lr_frac) * 0.5
                         * (1.0 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def warmup_poly(peak_lr: float, warmup_steps: int, total_steps: int,
                power: float = 1.0):
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        poly = peak_lr * (1.0 - prog) ** power
        return torch.where(step < warmup_steps, warm, poly)
    return fn


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
