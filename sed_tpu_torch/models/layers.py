"""Shared model building blocks (counterpart of ``sed_tpu.models.layers``).

NCHW layout: (batch, channels, time, mel).  Initialization matches the
reference: conv and linear weights ``kaiming_uniform_(a=0, fan_in,
leaky_relu)``, i.e. bound sqrt(6 / fan_in); biases zero; BatchNorm scale 1,
bias 0, running statistics (0, 1).  Draws come from an explicit
``torch.Generator``.  :class:`BatchNorm2d` and :class:`BatchNorm1d` update
their running variance in training as ``sed_tpu`` (flax) does.

A reduced compute dtype (bfloat16, the serving tier) works as flax's
``dtype``: the parameters and BatchNorm statistics stay float32;
:class:`Conv2d`, :class:`Conv1d` and :class:`Linear` cast their weights to
a bfloat16 input's dtype and compute in it; the batch norms normalize such
an input in float32 and return it in its own dtype (flax's ``_normalize``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
REDUCED_DTYPES = (torch.bfloat16, torch.float16)


def reduced_like(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """``t`` cast to ``x``'s dtype when that is a reduced one, else ``t``."""
    if t is None or x.dtype not in REDUCED_DTYPES:
        return t
    return t.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in a reduced input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, reduced_like(self.weight, x), reduced_like(self.bias, x))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that computes in a reduced input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, reduced_like(self.weight, x), reduced_like(self.bias, x))


class Linear(nn.Linear):
    """``nn.Linear`` that computes in a reduced input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, reduced_like(self.weight, x), reduced_like(self.bias, x))


class _BiasedRunningVar:
    """Mixin for a torch batch norm whose training forward updates
    ``running_var`` with the *biased* batch variance.

    This follows ``sed_tpu``'s flax ``BatchNorm`` (momentum 0.9, i.e. torch's
    0.1), not the original torch reference: torch's own layers store the
    unbiased variance, which would drift from ``sed_tpu``'s statistics most
    in the deep, small-spatial blocks.  The batch is still normalized with
    its biased variance, as both do; the evaluation forward, the parameters
    and the state-dict keys are the torch layer's.  torch's own update,
    ``r = (1 - m) * old + m * var * n / (n - 1)`` over the n values a
    channel has in the batch (batch x length, or batch x height x width),
    becomes ``r * (n - 1) / n + old * (1 - m) / n = (1 - m) * old + m *
    var``: no second pass over the batch.  The result replaces the buffer
    rather than writing into it, since autograd keeps the one the batch
    norm was given.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # A reduced input with the float32 statistics: torch normalizes it
            # in float32 and returns its own dtype, flax's ``_normalize``.
            return super().forward(x)
        n = x.numel() // x.shape[1]
        old = self.running_var.clone()
        y = super().forward(x)
        with torch.no_grad():
            self.running_var = torch.add(self.running_var * ((n - 1) / n), old,
                                         alpha=(1.0 - self.momentum) / n)
        return y


class BatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance (CnnAvgPooling,
    MobileNetV1)."""


class BatchNorm1d(_BiasedRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance (M5)."""


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
    """2 x (3x3 conv without bias -> BN (eps 1e-5) -> ReLU) -> avg pool.

    ``pool_size == 1`` is a no-op; larger pools floor odd sizes, as
    ``F.avg_pool2d`` and flax's VALID ``avg_pool`` both do.
    """

    def __init__(self, in_channels: int, out_channels: int, pool_size: int = 2):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_channels, eps=BN_EPS)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_channels, eps=BN_EPS)
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
