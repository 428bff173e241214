"""Host-side audio reading, channel policy and resampling (counterpart of
``sed_tpu.io.audio``).

WAV decode through ``scipy.io.wavfile`` with soundfile-style float
normalization, the reference's channel policy, and a polyphase Kaiser
windowed-sinc resampler (``scipy.signal.resample_poly`` with an explicit
64-zero-crossing FIR).  ``sed_tpu``'s optional native C++ reader is not
ported; this is the same math as its scipy path, and
:func:`read_multichannel_audio_batch` runs it in a thread pool where
``sed_tpu`` would use the native reader's.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from sed_tpu_torch.configs import DEFAULT_AUDIO, AudioConfig

KAISER_BEST_BETA = 14.769656459379492
KAISER_BEST_ZERO_CROSSINGS = 64


def _normalize_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float64 in [-1, 1), like soundfile.read defaults."""
    if data.dtype == np.int16:
        return data.astype(np.float64) / 2.0**15
    if data.dtype == np.int32:
        return data.astype(np.float64) / 2.0**31
    if data.dtype == np.uint8:
        return (data.astype(np.float64) - 128.0) / 128.0
    return data.astype(np.float64)


def read_wav(path: str):
    """Decode a WAV file -> (float64 (samples, channels), sample_rate)."""
    from scipy.io import wavfile

    sample_rate, data = wavfile.read(path)
    data = _normalize_to_float(np.asarray(data))
    if data.ndim == 1:
        data = data[:, None]
    return data, sample_rate


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float audio in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    clipped = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, sample_rate, (clipped * 32767.0).astype(np.int16))


def _kaiser_sinc_fir(up: int, down: int, beta: float = KAISER_BEST_BETA,
                     half_zero_crossings: int = KAISER_BEST_ZERO_CROSSINGS) -> np.ndarray:
    """Windowed-sinc FIR at the up-rate grid: cutoff pi/max(up, down), Kaiser
    window, half-width ``half_zero_crossings`` input-rate zero crossings,
    unit passband gain (``resample_poly`` scales by ``up`` itself)."""
    g = max(up, down)
    half = half_zero_crossings * g
    t = np.arange(-half, half + 1, dtype=np.float64)
    cutoff = 1.0 / g
    h = np.sinc(t * cutoff) * cutoff
    w = t / half
    h *= np.i0(beta * np.sqrt(np.maximum(1.0 - w * w, 0.0))) / np.i0(beta)
    return h


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample of a 1-D signal (Kaiser beta 14.77, 64 zero crossings)."""
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr)
    up, down = frac.numerator, frac.denominator
    return resample_poly(x, up, down, window=_kaiser_sinc_fir(up, down))


def read_multichannel_audio(
    audio_path: str,
    target_fs: int | None = None,
    cfg: AudioConfig = DEFAULT_AUDIO,
) -> np.ndarray:
    """Read + channel policy + resample; returns float64 (samples, channels).

    Channel policy: with fewer channels than requested, repeat the mean
    channel; with ``audio_channels == 1``, mono-ize by mean; with more
    channels, truncate.
    """
    audio, sample_rate = read_wav(audio_path)
    if audio.shape[1] < cfg.audio_channels:
        audio = np.repeat(audio.mean(axis=1, keepdims=True), cfg.audio_channels, axis=1)
    elif cfg.audio_channels == 1:
        audio = audio.mean(axis=1, keepdims=True)
    elif audio.shape[1] > cfg.audio_channels:
        audio = audio[:, : cfg.audio_channels]

    if target_fs is not None and sample_rate != target_fs:
        audio = np.stack(
            [resample(audio[:, i], sample_rate, target_fs) for i in range(audio.shape[1])],
            axis=1,
        )
    return audio


def read_multichannel_audio_batch(
    audio_paths,
    target_fs: int | None = None,
    cfg: AudioConfig = DEFAULT_AUDIO,
    workers: int = 0,
) -> list:
    """Many files -> list of float32 (samples, channels), in order.

    ``workers <= 1`` reads one file after another through
    :func:`read_multichannel_audio`; ``workers > 1`` runs the same reads in a
    ``ThreadPoolExecutor`` of that many threads (scipy's decode and
    resampling release the GIL for most of their time).
    """
    audio_paths = list(audio_paths)

    def read(path):
        return read_multichannel_audio(path, target_fs, cfg).astype(np.float32)

    if workers > 1 and len(audio_paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(read, audio_paths))
    return [read(p) for p in audio_paths]
