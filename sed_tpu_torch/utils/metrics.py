"""Frame-level detection metrics (counterpart of ``sed_tpu.utils.metrics``).

Reproduces the reference metric definitions (reference:
utils/metric_utils.py:4-37) with identical math, vectorized over the
threshold axis so the whole sweep runs as one array program.  A torch variant
computes the metrics on the device for the batch evaluator
(``inference.make_batch_evaluator``); the numpy variant is the host-side
oracle used by the eval loop and tests.

Reference semantics preserved exactly:
  * 21 thresholds ``np.arange(0.00, 1.05, 0.05)`` (metric_utils.py:5);
  * a prediction counts as a true positive iff ``2*T - O == 1``
    i.e. target==1 and hard output==1 (metric_utils.py:24);
  * degenerate conventions: recall := 1 when there is no ground truth,
    precision := 1 when there are no positive predictions
    (metric_utils.py:30-31);
  * AP is the Riemann sum ``sum(prec[:-1] * (rec[:-1] - rec[1:]))``
    (metric_utils.py:20);
  * f-score with a precision-importance factor beta (metric_utils.py:36-37).
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLDS = np.arange(0.00, 1.05, 0.05)


def compute_recall_precision(hard_output: np.ndarray, target: np.ndarray):
    """Recall/precision for one hard (0/1) prediction matrix.

    Reference: utils/metric_utils.py:23-33.
    """
    tp = ((2 * target - hard_output) == 1).sum()
    num_gt = target.sum()
    num_positives = hard_output.sum()
    recall = float(tp) / float(num_gt) if num_gt > 0 else 1.0
    prec = float(tp) / float(num_positives) if num_positives > 0 else 1.0
    return recall, prec


def calculate_metrics(output: np.ndarray, target: np.ndarray):
    """Threshold-sweep recall/precision curves plus average precision.

    Both inputs are (frames, classes) score/GT matrices; the frame axes are
    truncated to the common length first (reference: utils/metric_utils.py:6-8,
    handling the pooling-induced frame-count mismatch).

    Returns (recalls, precisions, AP) with recalls/precisions of shape (21,).
    """
    n = min(output.shape[0], target.shape[0])
    t = np.asarray(target)[:n].astype(np.float64)
    o = np.asarray(output)[:n].astype(np.float64)

    # (21, frames, classes) hard outputs for every threshold at once.
    hard = (o[None, ...] > THRESHOLDS.reshape((-1,) + (1,) * o.ndim)).astype(np.float64)
    tp = ((2.0 * t[None, ...] - hard) == 1.0).sum(axis=tuple(range(1, hard.ndim)))
    num_gt = t.sum()
    num_pos = hard.sum(axis=tuple(range(1, hard.ndim)))

    recalls = np.where(num_gt > 0, tp / max(num_gt, 1e-300), 1.0)
    precisions = np.where(num_pos > 0, tp / np.maximum(num_pos, 1e-300), 1.0)

    ap = np.sum(precisions[:-1] * (recalls[:-1] - recalls[1:]))
    return recalls, precisions, ap


def calculate_metrics_per_class(output: np.ndarray, target: np.ndarray):
    """Class-wise threshold-sweep curves + AP (the sed_eval class-wise view;
    the reference's own metric pools all classes, utils/metric_utils.py:24).

    Same math and degenerate conventions as :func:`calculate_metrics`, applied
    per class column: recall := 1 for a class with no ground truth, precision
    := 1 at thresholds where a class has no positive predictions.

    Returns (recalls, precisions, aps) of shapes ((21, C), (21, C), (C,));
    macro AP is ``aps.mean()``.  For each class c the results equal
    ``calculate_metrics(output[:, c:c+1], target[:, c:c+1])`` exactly.
    """
    n = min(output.shape[0], target.shape[0])
    t = np.asarray(target)[:n].astype(np.float64)
    o = np.asarray(output)[:n].astype(np.float64)

    hard = (o[None, ...] > THRESHOLDS.reshape(-1, 1, 1)).astype(np.float64)  # (21, n, C)
    tp = ((2.0 * t[None, ...] - hard) == 1.0).sum(axis=1)                    # (21, C)
    num_gt = t.sum(axis=0)                                                   # (C,)
    num_pos = hard.sum(axis=1)                                               # (21, C)

    recalls = np.where(num_gt[None, :] > 0, tp / np.maximum(num_gt[None, :], 1e-300), 1.0)
    precisions = np.where(num_pos > 0, tp / np.maximum(num_pos, 1e-300), 1.0)
    aps = np.sum(precisions[:-1] * (recalls[:-1] - recalls[1:]), axis=0)
    return recalls, precisions, aps


def calculate_metrics_torch(output: torch.Tensor, target: torch.Tensor):
    """Device-side variant of :func:`calculate_metrics` on tensors.

    ``output`` and ``target`` are (..., frames, classes) with frame axes that
    already agree; leading axes are batch axes (one sweep per recording).
    Returns (recalls (..., 21), precisions (..., 21), ap (...)) as float32
    tensors on ``output``'s device.
    """
    ths = torch.as_tensor(THRESHOLDS, dtype=torch.float32, device=output.device)
    t = target.to(torch.float32)[..., None, :, :]                  # (..., 1, F, C)
    o = output.to(torch.float32)[..., None, :, :]
    hard = (o > ths[:, None, None]).to(torch.float32)               # (..., 21, F, C)
    tp = ((2.0 * t - hard) == 1.0).to(torch.float32).sum(dim=(-2, -1))
    num_gt = t.sum(dim=(-2, -1))                                    # (..., 1)
    num_pos = hard.sum(dim=(-2, -1))                                # (..., 21)
    one = torch.ones((), device=output.device)
    recalls = torch.where(num_gt > 0, tp / num_gt.clamp_min(1e-30), one)
    precisions = torch.where(num_pos > 0, tp / num_pos.clamp_min(1e-30), one)
    ap = (precisions[..., :-1] * (recalls[..., :-1] - recalls[..., 1:])).sum(dim=-1)
    return recalls, precisions, ap


def f_score(recall, precision, precision_importance_factor: float = 1.0):
    """Weighted F-beta score (reference: utils/metric_utils.py:36-37).

    Note the reference passes (precision, recall) positionally from
    ProgressPlotter (utils/common.py:52-53) — callers here follow the same
    argument order as the reference function signature.
    """
    b2 = precision_importance_factor ** 2
    recall = np.asarray(recall, dtype=np.float64)
    precision = np.asarray(precision, dtype=np.float64)
    return (1 + b2) * recall * precision / (b2 * recall + precision + 1e-9)
