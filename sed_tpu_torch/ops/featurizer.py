"""Waveform -> log-mel featurizer (counterpart of ``sed_tpu.ops.featurizer``).

The kernels run on the tensor's device: a CUDA tensor goes through the
hand-written kernels of :mod:`sed_tpu_torch.ops.cuda_featurizer`, a CPU
tensor through their plain PyTorch versions.  ``sed_tpu``'s choices keep
their names and meaning:

  * ``use_pallas`` of :func:`logmel_features_batch`: 'auto' and 'full' are
    the fused waveform featurizer (K1 STFT power + K2 mel-log); True is the
    STFT in PyTorch (per ``fft_impl``) then the mel kernel (sed_tpu's K4,
    which is K2 here); False is PyTorch ops throughout, as sed_tpu's XLA
    path.  'auto' never resolves to False, on any device;
  * ``fft_impl`` ('fft', 'matmul', 'auto' = 'fft'): the STFT of the
    use_pallas=True/False paths (:mod:`sed_tpu_torch.ops.stft`);
  * :func:`logmel_frames` is K3 STFT power + K2 for pre-framed rows (the
    streaming tick); :func:`logmel_frames_xla` the same function in PyTorch
    ops (the tick's ``featurizer='xla'``); ``cuda_featurizer.logmel_waveform``
    takes every ``impl`` name of ``sed_tpu``'s ``logmel_waveform_pallas``;
  * ``pallas_precision`` / ``precision``: sed_tpu's serving tiers
    (:data:`FEATURIZER_PRECISION_TIERS`, :func:`resolve_featurizer_precision`)
    on the kernel paths: a reduced tier runs K1t (K3t for frames) in K1's
    (K3's) place, the bf16 tensor-core DFT; the PyTorch-ops paths ignore it,
    as sed_tpu's XLA path does.
"""

from __future__ import annotations

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops import stft as stft_ops
from sed_tpu_torch.ops.mulaw import mulaw_decode, mulaw_decode_np
from sed_tpu_torch.utils.precision import full_float32

# sed_tpu's serving tiers of the featurizer's FFT (its ops/featurizer.py):
# 'parity' the f32 kernels (K1, K3); 'fast' bf16x3 and 'turbo' bf16x1 split-
# operand products of its matmul DFT, here the bf16 tensor-core kernel (K1t,
# K3t).  The mel stage stays at parity in every tier.
FEATURIZER_PRECISION_TIERS = {
    "parity": None,
    "fast": "bf16x3",
    "turbo": "bf16x1",
}


def resolve_featurizer_precision(tier):
    """Map a user-facing tier name to a ``pallas_precision`` value.

    Accepts None (parity), a tier name from FEATURIZER_PRECISION_TIERS, or a
    raw precision string ('bf16x1'/'bf16x3'/'bf16x4'/'bf16x6') for
    benchmarking.  The PyTorch-ops (non-kernel) featurizer path ignores the
    value, as sed_tpu's XLA path does.
    """
    if tier is None:
        return None
    if tier in FEATURIZER_PRECISION_TIERS:
        return FEATURIZER_PRECISION_TIERS[tier]
    if tier in ("bf16x1", "bf16x3", "bf16x4", "bf16x6"):
        return tier
    raise ValueError(
        f"unknown featurizer precision tier {tier!r}: expected one of "
        f"{sorted(FEATURIZER_PRECISION_TIERS)} or a raw bf16xN string")


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


def resolve_pallas(use_pallas, cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM):
    """'auto' -> 'full' (the fused waveform featurizer, K1 + K2); any other
    value is returned as it is.

    On ``sed_tpu`` 'auto' means the fused Pallas path on a TPU and XLA
    elsewhere, and stays on XLA for configs with nfft < 32768, which Mosaic
    cannot lower.  On the port 'auto' means the hand-written kernels whenever
    the tensor is on CUDA (their plain versions on the CPU), for every
    config: K1 has no lower nfft limit, so there is no small-config
    exception.  ``cfg`` is kept for ``sed_tpu``'s signature.
    """
    return "full" if use_pallas == "auto" else use_pallas


def power_to_logmel(power: torch.Tensor,
                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                    use_pallas: bool = False) -> torch.Tensor:
    """(..., freq_bins) power spectrum -> (..., mel_bins) log-mel (float32).

    ``use_pallas=True`` is the mel kernel (sed_tpu's K4, K2 here, launched on
    a CUDA tensor); False is ``power @ fb`` in full float32 then
    ``power_to_db``, PyTorch ops as sed_tpu's XLA branch.
    """
    if use_pallas:
        return kernels.power_to_logmel_cuda(power, cfg)
    fb = torch.from_numpy(mel_ops.mel_filterbank(cfg)).to(power.device)
    with full_float32():
        melp = torch.matmul(power.to(torch.float32), fb)
    return mel_ops.power_to_db(melp)


def multichannel_stft(waveform: torch.Tensor,
                      cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                      fft_impl: str = "fft") -> torch.Tensor:
    """(samples, channels) -> (channels, frames, nfft//2+1) complex64, the
    per-channel centred STFT, frames-major."""
    return stft_ops.stft(waveform.transpose(0, 1).to(torch.float32), cfg, fft_impl)


def multichannel_stft_host(waveform, cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                           fft_impl: str = "auto", device=None) -> np.ndarray:
    """:func:`multichannel_stft` as a numpy complex64 array: the (real, imag)
    STFT runs on ``device`` and only the complex array is assembled on the
    host (``sed_tpu``'s variant for backends without complex types).

    ``device`` None is the tensor's own device for a tensor ``waveform`` and
    'cuda' for anything else (pass ``device='cpu'`` to run on the CPU).
    """
    from sed_tpu_torch.inference import resolve_device  # inference imports this module

    if device is None:
        device = waveform.device if isinstance(waveform, torch.Tensor) else "cuda"
    device = resolve_device(device)
    if not isinstance(waveform, torch.Tensor):
        waveform = np.asarray(waveform)
    y = torch.as_tensor(waveform, device=device).transpose(0, 1).to(torch.float32)
    re, im = stft_ops.stft_realimag(y, cfg, fft_impl)
    return re.cpu().numpy() + 1j * im.cpu().numpy().astype(np.float32)


def multichannel_complex_to_log_mel(spec: torch.Tensor,
                                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                                    use_pallas: bool = False) -> torch.Tensor:
    """|X|^2 -> mel projection -> 10*log10(max(1e-10, .)), float32.

    Takes any (..., freq_bins) tensor: complex spectrograms, or real rows
    (squared, as the reference's SVM baseline does with raw rfft rows).
    """
    if spec.is_complex():
        power = spec.real ** 2 + spec.imag ** 2
    else:
        power = spec.to(torch.float32) ** 2
    return power_to_logmel(power.to(torch.float32), cfg, use_pallas)


def realimag_to_log_mel(real: torch.Tensor, imag: torch.Tensor,
                        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                        use_pallas: bool = False) -> torch.Tensor:
    """Complex-free equivalent of :func:`multichannel_complex_to_log_mel`."""
    power = real.to(torch.float32) ** 2 + imag.to(torch.float32) ** 2
    return power_to_logmel(power, cfg, use_pallas)


def logmel_features_batch(waveforms: torch.Tensor,
                          cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                          fft_impl: str = "auto", use_pallas="auto",
                          pallas_precision=None) -> torch.Tensor:
    """(batch, samples, channels) -> (batch, channels, frames, mel_bins) float32.

    ``waveforms`` is float, int16 (PCM16) or uint8 (µ-law) on every path.
    ``use_pallas`` and ``fft_impl`` as in the module docstring: 'auto' and
    'full' run K1 + K2 on CUDA.  ``pallas_precision``: None (parity), or a
    reduced precision of sed_tpu (``resolve_featurizer_precision``'s values,
    or an (inner, outer) pair), which the 'full' path runs through K1t; the
    other paths ignore it, as sed_tpu's XLA path does.
    """
    if waveforms.ndim != 3:
        raise ValueError(f"waveforms must be (batch, samples, channels), "
                         f"got {tuple(waveforms.shape)}")
    b, samples, c = waveforms.shape
    signals = ingest_to_f32(
        waveforms.transpose(1, 2).reshape(b * c, samples)).contiguous()
    use_pallas = resolve_pallas(use_pallas, cfg)
    if use_pallas == "full":
        mel = kernels.logmel_waveform(signals, cfg, precision=pallas_precision)
    else:
        re, im = stft_ops.stft_realimag(signals, cfg, fft_impl)
        mel = realimag_to_log_mel(re, im, cfg, use_pallas)
    return mel.reshape(b, c, -1, cfg.mel_bins)


def logmel_features(waveform: torch.Tensor,
                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                    fft_impl: str = "auto", use_pallas="auto",
                    pallas_precision=None) -> torch.Tensor:
    """(samples, channels) -> (channels, frames, mel_bins) float32."""
    return logmel_features_batch(waveform[None], cfg, fft_impl, use_pallas,
                                 pallas_precision)[0]


def logmel_frames(frames: torch.Tensor, cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                  precision=None) -> torch.Tensor:
    """(rows, n_fft) raw frames, float32 or int16 (PCM16) -> (rows, mel_bins)
    float32 log-mel (counterpart of ``logmel_frames_pallas``).

    K3 then K2 on CUDA, both plain versions on CPU.  ``precision``: None
    (parity), or a reduced precision of sed_tpu (a value of
    ``resolve_featurizer_precision``, or an (inner, outer) pair), which runs
    K3t, the bf16 tensor-core DFT, in K3's place.
    """
    passes = kernels.tier_passes(precision)
    if frames.dtype != torch.int16:
        frames = frames.to(torch.float32)
    frames = frames.contiguous()
    device = frames.device
    window = kernels.stft_window(cfg, device)
    if passes is None:
        power = kernels.frames_stft_power(frames, window, cfg.nfft)
    else:
        power = kernels.frames_dft_power_bf16(frames, window, cfg.nfft, precision)
    return kernels.mel_log(power, kernels.mel_bands(cfg, device))


def logmel_frames_xla(frames: torch.Tensor,
                      cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM) -> torch.Tensor:
    """(rows, n_fft) raw frames, float32 or int16 (PCM16) -> (rows, mel_bins)
    float32 log-mel in PyTorch ops, no kernel of the port: the windowed rFFT
    (:func:`sed_tpu_torch.ops.stft.rfft_realimag`) then
    :func:`realimag_to_log_mel` (``sed_tpu``'s XLA tick featurizer)."""
    window = torch.tensor(stft_ops.padded_window(cfg.frame_size, cfg.nfft), device=frames.device)
    with full_float32():
        re, im = stft_ops.rfft_realimag(ingest_to_f32(frames) * window, cfg.nfft)
        return realimag_to_log_mel(re, im, cfg)
