"""Optimizer and learning-rate schedule (counterpart of ``sed_tpu.train.optim``).

Reference: train.py:80-110 — Adam(betas=(0.9, 0.999), eps=1e-8,
weight_decay=0, amsgrad=True) with the learning rate multiplied by 0.997
every 200 steps.  ``sed_tpu`` writes torch's AMSGrad out by hand for optax
(``scale_by_amsgrad_torch``); here it is ``torch.optim.Adam(amsgrad=True)``
itself.  The schedule is a ``LambdaLR`` stepped once after each optimizer
step, so update t (0-based) uses ``base_lr * 0.997 ** (t // 200)``, as optax
evaluates its schedule at the count before the update.
"""

from __future__ import annotations

import torch

LR_DECAY_FACTOR = 0.997
LR_DECAY_FREQ = 200


def lr_factor(step: int) -> float:
    """The schedule's multiplier of the base learning rate at update ``step``."""
    return LR_DECAY_FACTOR ** (step // LR_DECAY_FREQ)


def reference_lr_schedule(base_lr: float):
    """``step -> base_lr * 0.997 ** (step // 200)`` as a plain function."""

    def schedule(step):
        return base_lr * lr_factor(step)

    return schedule


def make_optimizer(model: torch.nn.Module, base_lr: float = 1e-6):
    """(optimizer, scheduler) over ``model``'s parameters: AMSGrad Adam and
    the reference's step decay.  Call ``scheduler.step()`` after each
    ``optimizer.step()``.  A parameter that never receives a gradient (the
    reference MobileNetV1's unused ``bn0``) is left untouched."""
    optimizer = torch.optim.Adam(model.parameters(), lr=base_lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.0, amsgrad=True)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor)
    return optimizer, scheduler
