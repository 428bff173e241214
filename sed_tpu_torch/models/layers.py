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

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sed_tpu_torch.parallel.mesh import all_reduce_sum_, gather_rows

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

    ``mesh``: set by :func:`global_batch_norm` for a data-parallel training
    forward, None otherwise.
    """

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # A reduced input with the float32 statistics: torch normalizes it
            # in float32 and returns its own dtype, flax's ``_normalize``.
            return super().forward(x)
        if self.mesh is not None:
            return self._global_batch_forward(x, self.mesh)
        n = x.numel() // x.shape[1]
        old = self.running_var.clone()
        y = super().forward(x)
        with torch.no_grad():
            self.running_var = torch.add(self.running_var * ((n - 1) / n), old,
                                         alpha=(1.0 - self.momentum) / n)
        return y

    def _global_batch_forward(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """Training forward under a mesh (:func:`global_batch_norm`): the
        statistics of the global batch, of which this rank holds a shard
        (:class:`_GlobalBatchNorm`); the running statistics take the global
        mean and biased variance.  (``nn.SyncBatchNorm`` would store the
        unbiased variance.)"""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, mesh)
        with torch.no_grad():
            m = self.momentum
            self.running_mean = torch.add(self.running_mean * (1.0 - m), mean, alpha=m)
            self.running_var = torch.add(self.running_var * (1.0 - m), var, alpha=m)
            self.num_batches_tracked += 1
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalization over the global batch, one equal shard a rank.

    Forward: each rank's per-channel mean and biased variance (one
    ``var_mean``), one all-gather of them, and the exact combination for
    equal counts (the mean of the means; the mean of the variances plus the
    variance of the means); then ``x * scale + shift`` in one pass.
    Backward: each rank's per-channel sums of ``g`` and ``g * (x - mean)``,
    one all-reduce of them, and the batch norm's input gradient from the
    global sums; the weight and bias gradients from the local sums (the
    optimizer step averages those over the ranks).  Two collectives a layer
    in all, where autograd through a differentiable all-reduce of the sum
    and the centred sum of squares needs four and many more small ops: the
    step is host-bound, and each collective costs ~0.2 ms of host time.  A
    reduced input is normalized in float32 (float64 stays float64) and
    returned in its own dtype, as without a mesh.  Returns ``(y, mean,
    var)``; the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var_r, mean_r = torch.var_mean(xf, dims, correction=0)
        stats = gather_rows(mesh, torch.stack([mean_r, var_r])[None])   # (ranks, 2, C)
        mean = stats[:, 0].mean(0)
        var = stats[:, 1].mean(0) + (stats[:, 0] - mean).square().mean(0)
        invstd = torch.rsqrt(var + eps)
        scale = invstd * weight
        y = torch.addcmul((bias - mean * scale).reshape(shape), xf, scale.reshape(shape))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        g = gy.to(mean.dtype)
        xc = x.to(mean.dtype) - mean.reshape(shape)
        local = torch.stack([g.sum(dims), (g * xc).sum(dims)])
        total = local.clone()
        all_reduce_sum_(ctx.mesh, total)
        n = x.numel() // x.shape[1] * ctx.mesh.size
        a = invstd * weight
        k1, k2 = total[0] / n, invstd * invstd * total[1] / n
        gx = torch.addcmul((-k1 * a).reshape(shape), g, a.reshape(shape))
        gx = torch.addcmul(gx, xc, (-k2 * a).reshape(shape))
        return gx.to(x.dtype), (invstd * local[1]).to(weight.dtype), \
            local[0].to(weight.dtype), None, None


@contextlib.contextmanager
def global_batch_norm(model: nn.Module, mesh):
    """For the code inside, ``model``'s batch norms normalize a training
    batch with the statistics of the global batch of ``mesh``, of which
    this rank holds an equal shard (:class:`_GlobalBatchNorm`); nothing
    changes with ``mesh`` None.  The train steps of ``data.device_pipeline``
    run their forward under it."""
    norms = [] if mesh is None else \
        [m for m in model.modules() if isinstance(m, _BiasedRunningVar)]
    for m in norms:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


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
