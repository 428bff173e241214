"""Waveform -> log-mel featurizer (counterpart of ``sed_tpu.ops.featurizer``).

One path per device, chosen by the tensor's device:

  * a CUDA tensor goes through the hand-written kernels of
    :mod:`sed_tpu_torch.ops.cuda_featurizer`: K1 STFT power + K2 mel-log for
    waveforms (:func:`logmel_features_batch`), K3 STFT power + K2 for
    pre-framed rows (:func:`logmel_frames`, the streaming tick);
  * a CPU tensor goes through their plain PyTorch versions.

``sed_tpu`` also chooses between an XLA path and several Pallas
implementations (``fft_impl``, ``use_pallas``, ``impl``); those choices
exist for the TPU and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.mulaw import mulaw_decode, mulaw_decode_np

# The parity tier is the only one ported.  sed_tpu's 'fast' ('bf16x3') and
# 'turbo' ('bf16x1') tiers, and its raw 'bf16xN' strings, count bf16 passes
# of the TPU's matrix unit in its matmul DFT; the port's FP32 kernels have no
# such passes (ROADMAP.md, queue 1: deferred featurizer tiers).
FEATURIZER_PRECISION_TIERS = ("parity",)
_UNPORTED_TIERS = ("fast", "turbo", "bf16x1", "bf16x3", "bf16x4", "bf16x6")


def resolve_featurizer_precision(tier):
    """None or 'parity' -> None (the parity featurizer).

    The reduced-precision tiers of ``sed_tpu`` raise ``NotImplementedError``
    (see ROADMAP.md); any other name raises ``ValueError``.
    """
    if tier is None or tier == "parity":
        return None
    if tier in _UNPORTED_TIERS:
        raise NotImplementedError(
            f"featurizer precision tier {tier!r} is not ported: the port runs "
            f"the parity tier only (see ROADMAP.md, deferred featurizer tiers)")
    raise ValueError(f"unknown featurizer precision tier {tier!r}: expected "
                     f"one of {FEATURIZER_PRECISION_TIERS} or None")


def ingest_to_f32(waveform: torch.Tensor) -> torch.Tensor:
    """Repo-wide ingest conventions -> float32 waveform on the same device.

    ``int16`` means PCM16 (de-quantized by 1/32768); ``uint8`` means µ-law
    bytes (ops/mulaw.py); floating inputs are cast to float32.
    """
    if waveform.dtype == torch.int16:
        return waveform.to(torch.float32) / 32768.0
    if waveform.dtype == torch.uint8:
        return mulaw_decode(waveform)
    if not waveform.is_floating_point():
        raise TypeError(f"unsupported waveform dtype {waveform.dtype}: "
                        f"expected float, int16 (PCM16) or uint8 (µ-law)")
    return waveform.to(torch.float32)


def ingest_to_f32_np(a) -> np.ndarray:
    """Host twin of :func:`ingest_to_f32` for numpy audio: int16 PCM is
    de-quantized by 1/32768, uint8 is µ-law-decoded, anything else is cast
    to float32."""
    a = np.asarray(a)
    if a.dtype == np.int16:
        return a.astype(np.float32) / 32768.0
    if a.dtype == np.uint8:
        return mulaw_decode_np(a)
    return a.astype(np.float32)


def power_to_logmel(power: torch.Tensor,
                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM) -> torch.Tensor:
    """(..., freq_bins) one-sided power -> (..., mel_bins) log-mel (float32)."""
    lead = power.shape[:-1]
    x = power.reshape(-1, power.shape[-1]).to(torch.float32).contiguous()
    mel = kernels.mel_log(x, kernels.mel_bands(cfg, power.device))
    return mel.reshape(*lead, cfg.mel_bins)


def logmel_features_batch(waveforms: torch.Tensor,
                          cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                          precision=None) -> torch.Tensor:
    """(batch, samples, channels) -> (batch, channels, frames, mel_bins) float32.

    ``waveforms`` is float, int16 (PCM16) or uint8 (µ-law).  It is featurized
    on its own device: K1 + K2 on CUDA, their plain versions on CPU.
    ``precision``: None or 'parity' (see :func:`resolve_featurizer_precision`).
    """
    resolve_featurizer_precision(precision)
    if waveforms.ndim != 3:
        raise ValueError(f"waveforms must be (batch, samples, channels), "
                         f"got {tuple(waveforms.shape)}")
    b, samples, c = waveforms.shape
    device = waveforms.device
    signals = ingest_to_f32(
        waveforms.transpose(1, 2).reshape(b * c, samples)).contiguous()
    power = kernels.wave_stft_power(signals, kernels.stft_window(cfg, device),
                                    cfg.hop_size, cfg.nfft)
    n_frames = power.shape[1]
    mel = kernels.mel_log(power.reshape(-1, cfg.freq_bins),
                          kernels.mel_bands(cfg, device))
    return mel.reshape(b, c, n_frames, cfg.mel_bins)


def logmel_features(waveform: torch.Tensor,
                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                    precision=None) -> torch.Tensor:
    """(samples, channels) -> (channels, frames, mel_bins) float32."""
    return logmel_features_batch(waveform[None], cfg, precision)[0]


def logmel_frames(frames: torch.Tensor, cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                  precision=None) -> torch.Tensor:
    """(rows, n_fft) raw frames, float32 or int16 (PCM16) -> (rows, mel_bins)
    float32 log-mel (counterpart of ``logmel_frames_pallas``).

    K3 then K2 on CUDA, both plain versions on CPU.  ``precision``: None or
    'parity' (see :func:`resolve_featurizer_precision`).
    """
    resolve_featurizer_precision(precision)
    if frames.dtype != torch.int16:
        frames = frames.to(torch.float32)
    frames = frames.contiguous()
    device = frames.device
    power = kernels.frames_stft_power(frames, kernels.stft_window(cfg, device), cfg.nfft)
    return kernels.mel_log(power, kernels.mel_bands(cfg, device))
