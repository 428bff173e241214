"""Slaney mel filterbank and dB conversion (counterpart of ``sed_tpu.ops.mel``).

The filterbank is the same float64 numpy math as ``sed_tpu`` (librosa's
``filters.mel`` with ``htk=False, norm='slaney'``), kept as the port's own
copy and held bit-exact against it by the tests.

Known divergence: ``sed_tpu`` computes the dB epilogue with
``log10_precise``, a software log written because the TPU's hardware log is
~3e-5 relative.  The port uses ``torch.log10`` (and the CUDA kernel the
accurate ``log10f``), which is ~1 ulp on CPU and GPU alike; the 1e-4 dB
featurizer tests pin the result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig

# Slaney auditory-toolbox mel scale constants (librosa hz_to_mel/mel_to_hz,
# htk=False).
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0

AMIN = 1e-10


def hz_to_mel(frequencies) -> np.ndarray:
    """Slaney-scale Hz -> mel (float64)."""
    f = np.asarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-30) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mels) -> np.ndarray:
    """Slaney-scale mel -> Hz (float64)."""
    m = np.asarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """n_mels frequencies spaced uniformly on the Slaney mel scale."""
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels)
    return mel_to_hz(mels)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_cached(sr: int, n_fft: int, n_mels: int, fmin: float,
                           fmax: float) -> np.ndarray:
    weights = np.zeros((n_mels, 1 + n_fft // 2), dtype=np.float64)
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization.
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    weights.setflags(write=False)
    return weights


def mel_filterbank(cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                   dtype=np.float32) -> np.ndarray:
    """(freq_bins, mel_bins) filterbank, transposed like the reference constant."""
    w = _mel_filterbank_cached(
        cfg.working_sample_rate, cfg.nfft, cfg.mel_bins,
        float(cfg.mel_min_freq), float(cfg.mel_max_freq),
    )
    return w.T.astype(dtype)


def power_to_db(power: torch.Tensor, amin: float = AMIN,
                ref: float = 1.0) -> torch.Tensor:
    """10*log10(max(amin, x)) - 10*log10(max(amin, ref)), top_db=None.

    Matches ``librosa.core.power_to_db(x, ref=1.0, amin=1e-10, top_db=None)``.
    """
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=amin))
    return log_spec - 10.0 * float(np.log10(max(amin, ref)))
