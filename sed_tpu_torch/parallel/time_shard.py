"""Time-axis geometry and exact windowed forwards of the fully convolutional
models (counterpart of ``sed_tpu.parallel.time_shard``).

The spectrogram models are fully convolutional over time, so one long
recording can be cut into windows with a halo of at least half the model's
receptive field on each side: the windows ride the batch axis of one
forward, and the halo outputs are trimmed.  Interior outputs equal the
whole-recording forward up to float32 summation order, because the
corruption from a window's zero-padded edge reaches at most half the
receptive field inward; the first and last windows start and end at the true
recording boundaries, so edge outputs are exact too.  Pooling-phase
alignment needs every window start to be a multiple of the total time stride.

The port's inputs are NCHW, ``(1, channels, frames, mel_bins)``: time is
dim 2.  Everything stays on the input's device; the scores come back as a
tensor there.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

TIME_DIM = 2


def receptive_field(model_config: Sequence[Tuple[int, int]]) -> int:
    """Time receptive field (frames) of a CnnAvgPooling stack.

    Each ConvBlock adds two k=3 convs (+2 frames each at the current stride),
    then multiplies the stride by its pool factor.
    """
    rf, stride = 1, 1
    for _, pool in model_config:
        rf += 4 * stride
        stride *= pool
    return rf


def pool_product(model_config: Sequence[Tuple[int, int]]) -> int:
    """Total time stride of a CnnAvgPooling stack."""
    p = 1
    for _, pool in model_config:
        p *= pool
    return p


def windowed_forward(
    forward: Callable,
    x: torch.Tensor,
    window: int,
    halo: int,
    total_stride: int = 8,
) -> torch.Tensor:
    """Exact fully convolutional forward over windows.

    Args:
      forward: (batch, channels, frames, mel) -> (batch, frames', classes),
        frame-rate preserving (frames' = stride * floor(frames / stride)).
      x: (1, channels, frames, mel), one long recording.
      window: retained frames per window (a multiple of ``total_stride``).
      halo: context frames on each side (a multiple of ``total_stride``, at
        least receptive_field // 2).

    Returns (1, frames_out, classes) on ``x``'s device, equal to
    ``forward(x)``.  The uniform windows go through one batched forward; a
    recording whose length is not stride-aligned adds one tail pass.
    """
    assert window % total_stride == 0 and halo % total_stride == 0
    t = x.shape[TIME_DIM]
    slice_len = window + 2 * halo
    if t <= slice_len:
        return forward(x)

    t_out = total_stride * (t // total_stride)
    n = math.ceil(t_out / window)

    starts = []
    for i in range(n):
        s = max(0, i * window - halo)
        if s + slice_len > t:
            # Last uniform window: the latest stride-aligned start that fits.
            s = total_stride * ((t - slice_len) // total_stride)
        starts.append(s)

    windows = torch.cat([x.narrow(TIME_DIM, s, slice_len) for s in starts])
    outs = forward(windows)  # (n, slice_len, classes)

    pieces = []
    covered = 0
    for i, s in enumerate(starts):
        retain_start = i * window
        # Outputs within ``halo`` of a slice edge are corrupted by the slice's
        # zero padding, unless that edge is the true recording boundary,
        # where zero padding is exactly what the whole forward does.
        trusted_end = s + slice_len if s + slice_len == t else s + slice_len - halo
        retain_end = min((i + 1) * window, t_out, trusted_end)
        if retain_end <= retain_start:
            continue
        pieces.append(outs[i, retain_start - s:retain_end - s])
        covered = retain_end

    if covered < t_out:
        # Ragged tail (t not stride-aligned): run [s_tail, t) directly so the
        # true right-edge conv padding matches the whole forward.
        s_tail = covered - halo
        tail_out = forward(x.narrow(TIME_DIM, s_tail, t - s_tail))[0]
        pieces.append(tail_out[covered - s_tail:t_out - s_tail])

    return torch.cat(pieces)[None]


def bucketed_forward_exact(
    forward: Callable,
    x: torch.Tensor,
    stride: int,
    halo: int,
    bucket: int = 64,
) -> torch.Tensor:
    """Variable-length exact forward over a few distinct input lengths.

    Zero-padding the time axis does not preserve the outputs of a fully
    convolutional stack (the pad becomes nonzero after the first BN bias),
    so this runs:

      * a main pass on ``x`` zero-padded to the next ``bucket`` multiple,
        exact for output frames < c = stride * floor((t - halo) / stride),
        whose receptive fields end before the pad;
      * a tail pass on ``x[..., s:t, :]`` with s = c - halo, whose right edge
        is the true recording end; s is stride-aligned, and t - s lies in
        [2 * halo, 2 * halo + stride).

    Recordings shorter than 2 * halo + stride run the plain forward.
    Returns (1, stride * floor(t / stride), classes), equal to ``forward(x)``.
    """
    assert halo % stride == 0 and bucket % stride == 0
    t = x.shape[TIME_DIM]
    if t < 2 * halo + stride:
        return forward(x)
    t_out = stride * (t // stride)
    c = stride * ((t - halo) // stride)

    b = bucket * (-(-t // bucket))
    pad = [0, 0] * (x.ndim - 1 - TIME_DIM) + [0, b - t]
    main = forward(F.pad(x, pad))  # (1, b, classes)

    s = c - halo
    tail = forward(x.narrow(TIME_DIM, s, t - s))  # (1, t_out - s, classes)
    return torch.cat([main[:, :c], tail[:, c - s:t_out - s]], dim=1)
