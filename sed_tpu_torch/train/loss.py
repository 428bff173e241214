"""Recall-weighted binary cross-entropy with logits (counterpart of
``sed_tpu.train.loss``).

Reference: utils/common.py:11-30 (WeightedBCE wrapping torch's
``binary_cross_entropy_with_logits`` with ``pos_weight=recall_factor``):

  loss = mean( pos_weight * t * softplus(-x) + (1 - t) * softplus(x) )

with, in multi-frame (spectrogram) mode, both tensors truncated on the frame
axis to the common length first (the reference's workaround for the
odd/even pooling frame-count mismatch, utils/common.py:20-22) and, in
single-frame (waveform) mode, logits and targets flattened
(utils/common.py:26-27).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _paired(logits, targets, multi_frame: bool):
    if multi_frame:
        n = min(logits.shape[1], targets.shape[1])
        return logits[:, :n], targets[:, :n]
    return logits.reshape(-1), targets.reshape(-1)


def weighted_bce_elementwise(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: float = 5.0,
                             multi_frame: bool = True) -> torch.Tensor:
    """The per-element terms of :func:`weighted_bce_with_logits`, before
    the mean: (batch, frames, classes) in multi-frame mode."""
    logits, targets = _paired(logits, targets, multi_frame)
    targets = targets.to(logits.dtype)
    return pos_weight * targets * F.softplus(-logits) + (1.0 - targets) * F.softplus(logits)


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: float = 5.0,
                             multi_frame: bool = True) -> torch.Tensor:
    """Scalar mean loss (a 0-d tensor on ``logits``' device)."""
    return weighted_bce_elementwise(logits, targets, pos_weight, multi_frame).mean()


def weighted_bce_with_logits_np(logits, targets, pos_weight: float = 5.0,
                                multi_frame: bool = True) -> float:
    """Host numpy twin of :func:`weighted_bce_with_logits` in float64, for
    the eval loop, where per-recording shapes vary."""
    logits, targets = _paired(np.asarray(logits, np.float64),
                              np.asarray(targets, np.float64), multi_frame)
    sp = lambda z: np.logaddexp(0.0, z)  # log(1 + e^z), overflow-safe
    loss = pos_weight * targets * sp(-logits) + (1.0 - targets) * sp(logits)
    return float(loss.mean())
