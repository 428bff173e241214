"""Shared model building blocks (counterpart of ``sed_tpu.models.layers``).

NCHW layout: (batch, channels, time, mel).  Initialization matches the
reference: conv and linear weights ``kaiming_uniform_(a=0, fan_in,
leaky_relu)``, i.e. bound sqrt(6 / fan_in); biases zero; BatchNorm scale 1,
bias 0, running statistics (0, 1).  Draws come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def kaiming_uniform_(weight: torch.Tensor,
                     generator: Optional[torch.Generator]) -> None:
    """In place: U(-sqrt(6/fan_in), sqrt(6/fan_in)), fan_in = in * kernel area."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def init_batch_norm_(bn: nn.BatchNorm2d) -> None:
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
    bn.reset_running_stats()


def interpolate(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Repeat each time step ``ratio`` times to undo pooling decimation.

    x: (batch, time_steps, classes) -> (batch, time_steps * ratio, classes).
    """
    if ratio == 1:
        return x
    return x.repeat_interleave(ratio, dim=1)


class ConvBlock(nn.Module):
    """2 x (3x3 conv without bias -> BN (eval, eps 1e-5) -> ReLU) -> avg pool.

    ``pool_size == 1`` is a no-op; larger pools floor odd sizes, as
    ``F.avg_pool2d`` and flax's VALID ``avg_pool`` both do.
    """

    def __init__(self, in_channels: int, out_channels: int, pool_size: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels, eps=BN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_channels, eps=BN_EPS)
        self.pool_size = pool_size

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for conv in (self.conv1, self.conv2):
            kaiming_uniform_(conv.weight, generator)
        for bn in (self.bn1, self.bn2):
            init_batch_norm_(bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if self.pool_size > 1:
            x = F.avg_pool2d(x, self.pool_size)
        return x
