"""Host-side audio reading, channel policy and resampling (counterpart of
``sed_tpu.io.audio``).

WAV decode through the native C++ reader (``sed_tpu_torch.io.native``,
built at first use), as ``sed_tpu`` decodes whenever its library is built:
PCM 8/16/24/32 and float32/64, the samples through float32, normalized like
soundfile.  Then the reference's channel policy and a polyphase Kaiser
windowed-sinc resampler (``scipy.signal.resample_poly`` with an explicit
64-zero-crossing FIR).  :func:`read_multichannel_audio_batch` with
``workers > 1`` runs the whole pipeline on the reader's C++ threads.

The plain versions, which the tests hold the reader against and the main
path never calls: :func:`read_wav_plain` (``scipy.io.wavfile``, float64
throughout) and :func:`read_multichannel_audio_batch_plain` (that decoder,
the same policy and scipy resampler, in a Python thread pool).
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
    """Decode a WAV file through the native reader -> (float64 (samples,
    channels), sample_rate).  A failed build of the reader raises."""
    from sed_tpu_torch.io.native import read_wav_native

    return read_wav_native(path)


def read_wav_plain(path: str):
    """:func:`read_wav`'s plain version: ``scipy.io.wavfile`` decode with
    soundfile-style normalization, float64 throughout."""
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
    return _policy_and_resample(audio, sample_rate, target_fs, cfg)


def _policy_and_resample(audio, sample_rate, target_fs, cfg):
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
    :func:`read_multichannel_audio`; ``workers > 1`` runs decode, channel
    policy and resampling on ``workers`` threads of the native reader
    (``load_multichannel_batch_native``, outside the GIL), as ``sed_tpu``
    does when its library is built.  At equal rates the two agree to the
    float32 rounding of the channel mean; a resampled file crosses from
    scipy's resampler to the reader's, the same Kaiser design, both within
    -140 dBFS of a float64 oracle (``benchmarks/RESAMPLER_PARITY.json``).
    """
    audio_paths = list(audio_paths)
    if workers > 1 and len(audio_paths) > 1:
        from sed_tpu_torch.io.native import load_multichannel_batch_native

        return load_multichannel_batch_native(audio_paths, cfg.audio_channels, target_fs,
                                              threads=workers)
    return [read_multichannel_audio(p, target_fs, cfg).astype(np.float32)
            for p in audio_paths]


def read_multichannel_audio_batch_plain(
    audio_paths,
    target_fs: int | None = None,
    cfg: AudioConfig = DEFAULT_AUDIO,
    workers: int = 0,
) -> list:
    """:func:`read_multichannel_audio_batch`'s plain version: the scipy
    decoder (:func:`read_wav_plain`), the same channel policy and scipy's
    resampler, on a ``ThreadPoolExecutor`` of ``workers`` threads when
    ``workers > 1``."""
    audio_paths = list(audio_paths)

    def read(path):
        audio, sample_rate = read_wav_plain(path)
        return _policy_and_resample(audio, sample_rate, target_fs, cfg).astype(np.float32)

    if workers > 1 and len(audio_paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(read, audio_paths))
    return [read(p) for p in audio_paths]
