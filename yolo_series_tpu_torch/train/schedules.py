"""LR schedules and warmup interpolation (counterpart of
`yolo_series_tpu/train/schedules.py`; reference train.py:192-196,
349-357). Computed on the host, in fp32 where the JAX package computes
in fp32 (0-d CPU tensors), in Python floats where it does."""

from __future__ import annotations

import math

import numpy as np
import torch


def _t(x):
    return torch.as_tensor(x, dtype=torch.float32)


def one_cycle_lr(epoch, epochs, lrf):
    """Cosine one-cycle factor 1 -> lrf (reference general.py one_cycle,
    train.py:193)."""
    return ((1 - torch.cos(_t(epoch * math.pi / epochs))) / 2) * (lrf - 1) + 1


def linear_lr(epoch, epochs, lrf):
    """Linear factor 1 -> lrf (reference train.py:196)."""
    return (1 - epoch / (epochs - 1)) * (1.0 - lrf) + lrf


def warmup_accumulate(ni, warmup_steps, final):
    """Grad-accumulation ramp during warmup (reference train.py:352-353):
    max(1, round(np.interp(ni, [0, nw], [1, nbs / bs]))). np.interp clamps
    past nw, so after warmup it stays at round(final)."""
    return max(1, int(np.interp(ni, [0, warmup_steps], [1, final]).round()))


def warmup_factors(step, warmup_steps, epoch_frac, epochs, lr0, lrf,
                   warmup_bias_lr, warmup_momentum, momentum, cosine=True):
    """(lr_groups (3,), momentum) during and after warmup (reference
    train.py:349-357): within warmup groups 0 and 1 ramp 0 -> lr x
    schedule, the bias group warmup_bias_lr -> lr x schedule, and the
    momentum warmup_momentum -> momentum. fp32 0-d / (3,) CPU tensors."""
    sched = (one_cycle_lr if cosine else linear_lr)(epoch_frac, epochs, lrf)
    target = lr0 * sched
    step_t = torch.as_tensor(step)
    t = torch.clamp(step_t / torch.clamp(torch.as_tensor(warmup_steps), min=1), 0.0, 1.0)
    t = t.to(torch.float32)
    in_warm = step_t < warmup_steps
    lr_main = torch.where(in_warm, t * target, target)
    lr_bias = torch.where(in_warm, warmup_bias_lr + t * (target - warmup_bias_lr), target)
    mom = torch.where(in_warm, warmup_momentum + t * (momentum - warmup_momentum),
                      _t(momentum))
    return torch.stack([lr_main, lr_main, lr_bias]), mom
