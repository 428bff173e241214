"""Device-resident training pipeline for the spectrogram family (counterpart
of the spectrogram half of ``sed_tpu.data.device_pipeline``).

The packed features of the training split are uploaded to the device once;
each train step then

  1. gathers the crop batch from the packed array (one advanced-index
     gather),
  2. applies mix/noise augmentation on the device (reference
     spectograms_dataset.py:112-135),
  3. normalizes (and, in 'Complex' mode, converts to log-mel after
     normalization — the reference transform-order quirk,
     spectograms_dataset.py:104-110),
  4. runs forward, loss, backward and the AMSGrad update.

The host sends only the (batch,) start indices each step.

Random draws: ``sed_tpu`` draws with ``jax.random``, which a
``torch.Generator`` cannot reproduce.  The augmentation is therefore split
into its draws (:func:`draw_augmentation`, from a device generator) and a
pure :func:`apply_augmentation`; the tests feed ``sed_tpu``'s draws to the
apply and compare.  The waveform half (M5) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import no_tf32
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops.stft import full_precision_matmul
from sed_tpu_torch.train.loss import weighted_bce_with_logits
from sed_tpu_torch.train.state import TrainState, apply_update

# Reference augmentation mix probabilities (spectograms_dataset.py:126) as
# cumulative thresholds on a uniform.
SPEC_MIX_CUM = (0.6, 0.85, 0.95)
MAX_MIX = 3


@dataclasses.dataclass
class SpectrogramBuffers:
    """Packed spectrogram store on the device.

    logMel mode: features (channels, total_frames, mel) float32, mean/std
    (mel,).  Complex mode: features (channels, total_frames, freq_bins, 2)
    float32, real and imaginary parts on the last axis, as ``sed_tpu``
    carries them; mean (freq_bins, 2), std (freq_bins,) (numpy's complex
    std is real).
    """

    features: torch.Tensor
    events: torch.Tensor         # (total_frames, classes) float32
    start_indices: torch.Tensor  # (num_starts,) int64, for the mix draws
    mean: torch.Tensor
    std: torch.Tensor


def spectrogram_buffers_from_dataset(dataset, device="cuda") -> SpectrogramBuffers:
    """Upload a :class:`SpectrogramDataset`'s training split, once."""
    feats = dataset.train_features
    mean = np.asarray(dataset.mean)
    std = np.asarray(dataset.std)
    if np.iscomplexobj(feats):
        features = np.stack([feats.real, feats.imag], axis=-1).astype(np.float32)
        mean = np.stack([mean.real, mean.imag], axis=-1)
        std = std.real
    else:
        features = feats.astype(np.float32)

    def up(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return SpectrogramBuffers(
        features=up(features),
        events=up(dataset.train_event_matrix),
        start_indices=up(dataset.train_start_indices, np.int64),
        mean=up(mean),
        std=up(std),
    )


def make_gather_crops(cfg: SpectrogramConfig) -> Callable:
    """``gather(buffers, starts (B,)) -> (feats (B, C, crop, bins[, 2]),
    events (B, crop, classes))``: one advanced-index row gather."""
    crop = cfg.train_crop_size

    def gather_crops(buffers: SpectrogramBuffers, starts: torch.Tensor):
        idx = starts.to(torch.int64)[:, None] + torch.arange(crop, device=starts.device)
        f = buffers.features[:, idx].movedim(1, 0)   # (B, C, crop, ...)
        return f, buffers.events[idx]

    return gather_crops


def make_transform(cfg: SpectrogramConfig, preprocessed_mode: str = "logMel") -> Callable:
    """``transform(buffers, x)``: normalization, and in Complex mode the
    log-mel of the normalized spectrum (the reference quirk,
    spectograms_dataset.py:104-110).

    The mel projection is a float32 matmul with TF32 off, as ``sed_tpu``'s
    (``power_to_logmel(..., use_pallas=False)``), not the mel kernel.  The
    filterbank is uploaded once per device and dtype.
    """
    complex_mode = preprocessed_mode != "logMel"
    fbs = {}

    def transform(buffers: SpectrogramBuffers, x: torch.Tensor) -> torch.Tensor:
        if not complex_mode:
            return (x - buffers.mean) / buffers.std
        # x: (B, C, crop, bins, 2); mean (bins, 2); std (bins,).
        x = (x - buffers.mean) / buffers.std[..., None]
        power = (x * x).sum(dim=-1)
        fb = fbs.get((x.device, x.dtype))
        if fb is None:
            fb = fbs[x.device, x.dtype] = torch.from_numpy(
                mel_ops.mel_filterbank(cfg)).to(x.device, x.dtype)
        with full_precision_matmul():
            mel = torch.matmul(power, fb)
        return mel_ops.power_to_db(mel)

    return transform


@dataclasses.dataclass
class AugmentDraws:
    """The random draws of one augmented batch of B crops.

    ``u_mix`` (B,) uniform: the number of extra crops mixed in, by
    :data:`SPEC_MIX_CUM`; ``ptr`` (B, MAX_MIX) int64: which start indices;
    ``u_noise`` (B,) uniform: the noise gate (> 0.5) and its scale;
    ``noise`` standard normal, the batch's shape (in Complex mode without
    the real/imaginary axis: the noise lands on the real part only).
    """

    u_mix: torch.Tensor
    ptr: torch.Tensor
    u_noise: torch.Tensor
    noise: torch.Tensor


def draw_augmentation(generator: torch.Generator, buffers: SpectrogramBuffers,
                      feats_shape, complex_mode: bool) -> AugmentDraws:
    """Draw from ``generator`` (on the buffers' device)."""
    device = buffers.features.device
    batch = feats_shape[0]
    noise_shape = tuple(feats_shape[:-1]) if complex_mode else tuple(feats_shape)
    return AugmentDraws(
        u_mix=torch.rand(batch, generator=generator, device=device),
        ptr=torch.randint(0, buffers.start_indices.shape[0], (batch, MAX_MIX),
                          generator=generator, device=device),
        u_noise=torch.rand(batch, generator=generator, device=device),
        noise=torch.randn(noise_shape, generator=generator, device=device),
    )


def apply_augmentation(buffers: SpectrogramBuffers, feats: torch.Tensor,
                       events: torch.Tensor, draws: AugmentDraws, gather_crops: Callable,
                       complex_mode: bool):
    """Mix + noise (reference spectograms_dataset.py:112-135) for given draws.

    Each crop is averaged with k extra crops (k from ``u_mix``) and its
    events are the union of theirs; then, where ``u_noise > 0.5``, noise of
    std 0.001 + (u_noise + 0.5) * 0.004 is added (to the real part only in
    Complex mode, numpy's ``complex += real`` semantics).
    """
    batch = feats.shape[0]
    k = sum((draws.u_mix > t).to(torch.int64) for t in SPEC_MIX_CUM)      # (B,)
    extra = buffers.start_indices[draws.ptr]                              # (B, MAX_MIX)
    ef, ee = gather_crops(buffers, extra.reshape(-1))
    ef = ef.reshape((batch, MAX_MIX) + tuple(feats.shape[1:]))
    ee = ee.reshape((batch, MAX_MIX) + tuple(events.shape[1:]))
    mask = (torch.arange(MAX_MIX, device=feats.device)[None, :] < k[:, None]).to(feats.dtype)
    fmask = mask.reshape(mask.shape + (1,) * (ef.ndim - 2))
    kdiv = (k + 1).to(feats.dtype).reshape((batch,) + (1,) * (feats.ndim - 1))
    feats = (feats + (ef * fmask).sum(dim=1)) / kdiv
    events = torch.maximum(events, (ee * mask[:, :, None, None]).amax(dim=1))

    gate_shape = (batch,) + (1,) * (draws.noise.ndim - 1)
    r = draws.u_noise.reshape(gate_shape)
    noise = draws.noise * (0.001 + (r + 0.5) * (0.005 - 0.001))
    if complex_mode:
        real = torch.where(r > 0.5, feats[..., 0] + noise, feats[..., 0])
        feats = torch.stack([real, feats[..., 1]], dim=-1)
    else:
        feats = torch.where(r > 0.5, feats + noise, feats)
    return feats, events


def make_augment_batch(cfg: SpectrogramConfig, preprocessed_mode: str = "logMel") -> Callable:
    """``augment(generator, buffers, feats, events) -> (feats, events)``:
    :func:`draw_augmentation` then :func:`apply_augmentation`."""
    complex_mode = preprocessed_mode != "logMel"
    gather_crops = make_gather_crops(cfg)

    def augment_batch(generator, buffers: SpectrogramBuffers, feats, events):
        draws = draw_augmentation(generator, buffers, feats.shape, complex_mode)
        return apply_augmentation(buffers, feats, events, draws, gather_crops, complex_mode)

    return augment_batch


def make_spectrogram_train_step(
    cfg: SpectrogramConfig,
    pos_weight: float = 5.0,
    preprocessed_mode: str = "logMel",
    augment: bool = False,
) -> Callable:
    """``step(state, buffers, starts (B,), generator=None) -> loss``: gather,
    augment (with ``augment``, drawing from ``generator``), transform,
    forward, loss, backward and the optimizer step, on the buffers' device.
    The loss comes back detached, on the device.  Each part runs in a
    ``torch.profiler`` range (``train_step/gather``, ``/augment``,
    ``/transform``, ``/forward``, ``/backward``, ``/optimizer``).  TF32 is
    turned off for the process (``inference.no_tf32``), as ``sed_tpu``
    trains at full float32 precision."""
    no_tf32()
    gather_crops = make_gather_crops(cfg)
    transform = make_transform(cfg, preprocessed_mode)
    augment_batch = make_augment_batch(cfg, preprocessed_mode)

    def step(state: TrainState, buffers: SpectrogramBuffers, starts, generator=None):
        with record_function("train_step/gather"):
            starts = torch.as_tensor(starts, device=buffers.features.device)
            feats, events = gather_crops(buffers, starts)
        if augment:
            with record_function("train_step/augment"):
                feats, events = augment_batch(generator, buffers, feats, events)
        with record_function("train_step/transform"):
            x = transform(buffers, feats)              # (B, C, crop, mel): NCHW
        with record_function("train_step/forward"):
            state.model.train()
            loss = weighted_bce_with_logits(state.model(x), events, pos_weight,
                                            multi_frame=True)
        apply_update(state, loss)
        return loss.detach()

    return step
