"""Full float32 precision on the card, scoped to a call."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and matrix products in full float32 (TF32 off) for
    the duration, restoring the caller's two settings after.

    Both run float32 in TF32 by default on the card, which keeps about three
    decimal digits: the scores would leave the 1e-5 budget against
    ``sed_tpu``, which sets its precision per operation.  Every entry point
    of the port that scores or trains enters this around its work.
    """
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
