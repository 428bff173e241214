"""Centred STFT with librosa semantics (counterpart of ``sed_tpu.ops.stft``).

The reference calls ``librosa.core.stft(y, n_fft=32768, win_length=31680,
hop_length=15840, window=np.hanning(31680), center=True, pad_mode='reflect')``:

  1. the symmetric Hann window ``np.hanning(win_length)`` is zero-padded
     centred into the n_fft buffer (left pad (n_fft - win_length) // 2 = 544);
  2. the signal is reflect-padded by n_fft//2 on both sides (the edge sample
     is not repeated, as ``jnp.pad(mode="reflect")``);
  3. frames of n_fft samples are taken every hop: n_frames = 1 + len // hop;
  4. each frame is windowed and goes through a real FFT (n_fft//2 + 1 bins).

This module is the plain path, on ``torch.fft.rfft``.  ``sed_tpu`` runs the
FFT as Cooley-Tukey matmul stages at Precision.HIGHEST because the TPU has
no accurate native FFT; on CPU and GPU ``torch.fft`` is accurate float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig


def symmetric_hann(win_length: int) -> np.ndarray:
    """np.hanning: 0.5 - 0.5*cos(2*pi*n/(N-1)), zero at both endpoints."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))


@functools.lru_cache(maxsize=8)
def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Symmetric Hann centred in an n_fft-length zero buffer (float64 -> float32)."""
    w = symmetric_hann(win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad:lpad + win_length] = w
    out = out.astype(np.float32)
    out.setflags(write=False)
    return out


def num_frames(n_samples: int, hop: int) -> int:
    """Frame count for a centre-padded STFT: 1 + floor(n / hop)."""
    return 1 + n_samples // hop


def reflect_indices(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each sample of a signal of ``n`` samples
    reflect-padded by ``pad`` on both sides, as ``np.pad(mode="reflect")``:
    the edge sample is not repeated, and pads longer than the signal
    reflect again (period 2(n-1))."""
    if n < 1:
        raise ValueError("cannot reflect-pad an empty signal")
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft) reflect-centred frames (a view
    of one padded copy of the signal)."""
    ypad = y[..., reflect_indices(y.shape[-1], n_fft // 2, y.device)]
    return ypad.unfold(-1, n_fft, hop)


def windowed_frames(y: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    window = torch.tensor(padded_window(cfg.frame_size, cfg.nfft),
                          dtype=y.dtype, device=y.device)
    return frame_signal(y, cfg.nfft, cfg.hop_size) * window


def stft_realimag(y: torch.Tensor,
                  cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM):
    """(..., samples) -> ((..., frames, bins) real, (..., frames, bins) imag)."""
    spec = torch.fft.rfft(windowed_frames(y, cfg), dim=-1)
    return spec.real, spec.imag


def stft(y: torch.Tensor,
         cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft//2+1) complex, frames-major."""
    return torch.fft.rfft(windowed_frames(y, cfg), dim=-1)
